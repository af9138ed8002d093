"""Bulk-reformat/validate every experiment's `.hparams.json` against the
config records (parity: /root/reference/playground/fmt_hparams.py).

Run: python playground/fmt_hparams.py
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

EXPERIMENTS = pathlib.Path(__file__).parent.parent / "experiments"


def main() -> None:
    from autognothi.pipeline.config import ExpConfig

    for exp in sorted(EXPERIMENTS.iterdir()):
        hp = exp / ".hparams.json"
        if not hp.exists():
            continue
        raw = json.loads(hp.read_text())
        cfg = ExpConfig.from_dict(raw)  # fail on schema violations
        dumped = cfg.to_dict(exclude_unset=True)
        hp.write_text(json.dumps(dumped, indent=2) + "\n")
        print(f"ok: {hp}")


if __name__ == "__main__":
    main()
