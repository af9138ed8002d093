"""`python -m autognothi <command> <experiment_dir> ...` — same CLI as
`./main.py` (parity: /root/reference/main.py) for installed deployments."""

from .cli import main

if __name__ == "__main__":
    main()
