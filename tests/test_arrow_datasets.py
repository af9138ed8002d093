"""The real-data (HF arrow) loader path, exercised end-to-end against LOCAL
arrow fixtures (verdict r3 #5): zero egress blocks the actual downloads, but
everything downstream of `load_dataset` — the on-disk arrow cache round trip,
seeded test subsetting, row filtering, imagenette label remap, grayscale
promotion, transform chain and batch collate (parity targets:
/root/reference/datasets/loader.py:68-132,339-366) — runs for real here.

The fixtures are tiny `datasets.DatasetDict`s saved with the same schema the
hub sets have (yelp: text/label; imagenette: image/label), dropped exactly
where `_hf_dataset` looks for its cache, so `load_from_disk` serves them and
no network is touched.
"""

import json
import pathlib

import numpy as np
import pytest

hfds = pytest.importorskip("datasets")
PIL_Image = pytest.importorskip("PIL.Image")

import autognothi.data.loader as dl  # noqa: E402
from autognothi.data.loader import CvTransforms  # noqa: E402

# texts long enough to pass the >=32-char quality filter, plus rejects
GOOD = [
    f"this review number {i} is definitely long enough to pass the filter"
    for i in range(12)
]
SHORT = ["too short", "nope"]  # filtered out (len < 32)


def _build_yelp(root: pathlib.Path) -> None:
    train = hfds.Dataset.from_dict({
        "text": GOOD[:8] + SHORT,
        "label": [i % 2 for i in range(8)] + [0, 1],
    })
    test = hfds.Dataset.from_dict({
        "text": GOOD[8:12] + SHORT[:1],
        "label": [i % 2 for i in range(4)] + [1],
    })
    hfds.DatasetDict({"train": train, "test": test}).save_to_disk(
        str(root / "yelp_polarity"))


def _build_imagenette(root: pathlib.Path) -> None:
    rng = np.random.RandomState(3)

    def img(mode: str, size) -> "PIL_Image.Image":
        arr = (rng.rand(*size, 3 if mode == "RGB" else 1) * 255).astype(
            np.uint8)
        return PIL_Image.fromarray(arr.squeeze(), mode=mode)

    # varied sizes (the resize transform must unify them) + one grayscale
    # (exercises the 2D -> 3-channel promotion)
    train_imgs = [img("RGB", (40, 56)), img("RGB", (24, 24)),
                  img("L", (32, 32)), img("RGB", (48, 32)),
                  img("RGB", (30, 30)), img("RGB", (28, 44)),
                  img("RGB", (36, 36)), img("RGB", (50, 20))]
    train_labels = list(range(8))  # hub positions 0..7
    val_imgs = [img("RGB", (33, 27)), img("RGB", (21, 41)),
                img("RGB", (25, 25)), img("L", (20, 20))]
    val_labels = [2, 2, 2, 2]  # hub position 2 remaps to model label 0
    feats = hfds.Features({"image": hfds.Image(),
                           "label": hfds.Value("int64")})
    dd = hfds.DatasetDict({
        "train": hfds.Dataset.from_dict(
            {"image": train_imgs, "label": train_labels}, features=feats),
        "validation": hfds.Dataset.from_dict(
            {"image": val_imgs, "label": val_labels}, features=feats),
    })
    dd.save_to_disk(str(root / "imagenette"))


@pytest.fixture(scope="module")
def arrow_home(tmp_path_factory):
    """Point the loader's arrow cache root at a dir of local fixtures."""
    root = tmp_path_factory.mktemp("arrow_fixtures")
    _build_yelp(root)
    _build_imagenette(root)
    old = dl._HERE
    dl._HERE = root
    try:
        yield root
    finally:
        dl._HERE = old


def test_yelp_arrow_subsetting_and_filtering(arrow_home):
    loader = dl.load_yelp_polarity(train_size=6, test_size=4, test_seed=123)
    train_rows = [(x, y) for xs, ys in loader.train(4)
                  for x, y in zip(xs, ys)]
    assert 0 < len(train_rows) <= 6  # subset of 6, minus filtered rejects
    assert all(len(x) >= 32 and y in (0, 1) for x, y in train_rows)

    # the test split subsets DETERMINISTICALLY in test_seed
    test_a = [x for xs, *_ in loader.test_raw(2) for x in xs]
    test_b = [x for xs, *_ in loader.test_raw(2) for x in xs]
    assert test_a == test_b and len(test_a) >= 1
    assert all(len(x) >= 32 for x in test_a)  # the short reject is dropped


def test_imagenette_arrow_remap_and_transforms(arrow_home):
    tf = CvTransforms(resize={"height": 16, "width": 16})
    loader = dl.load_imagenette(train_size=8, test_size=4, test_seed=7,
                                transforms=tf)
    n = 0
    for xs, ys, xr, yr in loader.train_raw(4):
        for x, y, raw in zip(xs, ys, xr):
            assert x.shape == (3, 16, 16) and x.dtype == np.float32
            assert 0 <= y < 10
            # raws stay un-normalized <3, h, w> in [0, 1]
            assert raw.ndim == 3 and raw.shape[0] == 3
            assert 0.0 <= raw.min() and raw.max() <= 1.0
            n += 1
    assert n == 8  # all eight hub labels are remappable

    # hub label position 2 -> model label 0 (the reference's ordering,
    # datasets/loader.py:339-366)
    val_ys = [y for _xs, ys in loader.test(4) for y in ys]
    assert val_ys == [0] * len(val_ys) and len(val_ys) == 4


def test_imagenette_run_all_e2e(arrow_home, tmp_path):
    """The full pipeline (7 train stages + reports) over the arrow branch:
    what `run_all` does on the real imagenette, on the local fixture."""
    from tests.test_train_all_e2e import MINI_VIT_HPARAMS

    hparams = json.loads(json.dumps(MINI_VIT_HPARAMS))  # deep copy
    hparams["dataset"] = {
        "kind": "imagenette", "train_size": 8, "test_size": 4,
        "test_seed": 7,
        "transforms": {"resize": {"height": 16, "width": 16}},
    }
    hparams["net"]["params"]["num_labels"] = 10
    exp = tmp_path / "imagenette_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hparams, indent=2))

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.measure_all import measure_all
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    assert "verified final model is coherent" in (exp / ".log.txt").read_text()
    measure_all(env)
    faith = json.loads((exp / ".reports" / "faithfulness.json").read_text())
    assert 0.0 <= faith["insertion"]["auc"] <= 1.0


def test_yelp_run_all_e2e(arrow_home, tmp_path):
    """Text track: mini vanilla-BERT trained over the yelp arrow branch."""
    from autognothi.data.tokenizer import WordPieceTokenizer, build_vocab
    from tests.test_bert_e2e import make_bert_hparams

    vocab = build_vocab(GOOD, max_size=200)
    exp = tmp_path / "yelp_mini"
    exp.mkdir()
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    hparams = make_bert_hparams(len(vocab))
    hparams["dataset"] = {"kind": "yelp_polarity", "train_size": 8,
                          "test_size": 4, "test_seed": 11}
    (exp / ".hparams.json").write_text(json.dumps(hparams, indent=2))

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(exp)
    train_all(env)
    assert (exp / "final-epoch-0.ckpt").exists()
    assert "verified final model is coherent" in (exp / ".log.txt").read_text()
