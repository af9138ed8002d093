#!/usr/bin/env python3
"""CLI entrypoint: `python ./main.py <command> <experiment_dir> ...`
(parity: /root/reference/main.py)."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from autognothi.cli import main

if __name__ == "__main__":
    main()
