"""Build the bundled yelp_polarity_mini set from the full yelp dataset,
keeping only samples the fine-tuned base classifier predicts correctly
(parity: /root/reference/playground/shrink_datasets.py).

Run: python playground/shrink_datasets.py  (requires yelp_polarity cached
and an ft_bert_base_yelp zoo export)
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

OUT = (
    pathlib.Path(__file__).parent.parent
    / "autognothi" / "data" / "yelp_polarity_mini.json"
)


def main(n_samples: int = 64) -> None:
    import jax.numpy as jnp
    import numpy as np

    from autognothi.data.loader import load_yelp_polarity
    from autognothi.data.tokenizer import encode_batch
    from autognothi.models.bert import VanillaBertConfig, bert_classifier_fwd
    from autognothi.zoo.loader import load_params

    params_np, tokenizer = load_params("ft_bert_base_yelp", num_labels=2)
    if params_np is None or tokenizer is None:
        raise SystemExit("ft_bert_base_yelp not found — run pretrain first")
    params = {k: jnp.asarray(v) for k, v in params_np.items()}
    with open(
        pathlib.Path(__file__).parent.parent / "autognothi" / "zoo"
        / "store" / "ft_bert_base_yelp" / "model.json"
    ) as f:
        cfg = VanillaBertConfig.from_dict(json.load(f))

    loader = load_yelp_polarity(train_size=8, test_size=38000, test_seed=2333)
    kept = []
    for texts, labels in loader.test(16):
        ids = encode_batch(tokenizer, texts, cfg.max_position_embeddings)
        mask = jnp.ones_like(jnp.asarray(ids))
        ttype = jnp.zeros_like(jnp.asarray(ids))
        probs, _ = bert_classifier_fwd(params, cfg, jnp.asarray(ids), mask, ttype)
        preds = np.argmax(np.asarray(probs), axis=1)
        for text, label, pred in zip(texts, labels, preds):
            if label == int(pred):
                kept.append({"inputs": text, "targets": label})
        if len(kept) >= n_samples:
            break

    OUT.write_text(json.dumps(kept[:n_samples], indent=2) + "\n")
    print(f"wrote {min(len(kept), n_samples)} samples -> {OUT}")


if __name__ == "__main__":
    main()
