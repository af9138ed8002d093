"""Experiment environment: directory, config, logging, metrics.

Parity with the reference's scripts/env.py: owns the experiment directory,
validates `.hparams.json` into ExpConfig, appends timestamped lines to
`.log.txt`, pushes metrics to wandb when configured (console fallback
otherwise), acts as a context manager for the logger lifecycle, rewrites the
config in place to persist wandb run ids, and `fork()`s per-stage logger
views over the same config + log file.
"""

from __future__ import annotations

import datetime
import json
import pathlib
from typing import Any, Callable, Dict, Optional, TextIO, Tuple

from .config import Config_Logger, ExpConfig

# Console styling rules, evaluated top-down against the timestamped line.
# Each rule: (requires_banner, substrings_any, style).  The first rule whose
# substrings intersect the message wins; banner rules only apply to lines
# wrapped in `[[[ ... ]]]`.  These reproduce the reference's color scheme.
_STYLE_RULES = (
    (True, ("!!!", "error", "failed"), "bold red1"),
    (True, ("...", "ing "), "bold sky_blue2"),
    (True, ("ok", "done", "ed "), "bold green1"),
    (True, (), "pale_violet_red1"),
    (False, ("!!! ",), "indian_red1"),
)


def _style_for(msg: str) -> Optional[str]:
    banner = "[[[" in msg and "]]]" in msg
    for needs_banner, needles, style in _STYLE_RULES:
        if needs_banner != banner:
            continue
        if not needles or any(n in msg for n in needles):
            return style
    return None


try:
    import rich

    _console = rich.get_console()

    def _print(msg: str, style: Optional[str]) -> None:
        _console.print(msg, style=style)

except ImportError:  # pragma: no cover

    def _print(msg: str, style: Optional[str]) -> None:
        print(msg)


def _try_wandb():
    try:
        import wandb

        return wandb
    except ImportError:
        return None


# type of the per-stage logger-options selector (stage trainers pick their
# own wandb section out of the shared ExpConfig)
LoggerOpts = Callable[[ExpConfig], Optional[Config_Logger]]


class ExpEnv:
    """The one object handed through the whole pipeline: config + loggers."""

    config: ExpConfig
    model_path: pathlib.Path
    _log_fd: TextIO

    def __init__(
        self,
        model_path: pathlib.Path,
        get_logger_opts: LoggerOpts = lambda cfg: None,
        _forked: Optional[Tuple[ExpConfig, TextIO]] = None,
    ) -> None:
        self.model_path = pathlib.Path(model_path)
        self._get_logger_opts = get_logger_opts
        if _forked:
            self.config, self._log_fd = _forked
            return
        self.config = ExpConfig.from_dict(
            json.loads((self.model_path / ".hparams.json").read_text("utf-8"))
        )
        self._log_fd = open(self.model_path / ".log.txt", "a", encoding="utf-8")
        self.log(
            f"[[[ NEW RUN: load config from "
            f"{self.model_path.absolute().as_posix()} ]]]"
        )

    def fork(self, get_logger_opts: LoggerOpts) -> "ExpEnv":
        """Same experiment, different logger options (per-stage wandb)."""
        return ExpEnv(
            self.model_path, get_logger_opts,
            _forked=(self.config, self._log_fd),
        )

    # ------------------------------------------------------------- logging

    def log(self, msg: str) -> None:
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
        line = f"[{ts}] {msg}"
        _print(line, _style_for(line))
        if not self._log_fd.closed:
            self._log_fd.write(line + "\n")
            self._log_fd.flush()

    def metrics(self, data: Dict[str, Any]) -> None:
        opts = self._get_logger_opts(self.config)
        wandb = _try_wandb()
        if opts is None or not opts.wandb_enabled or wandb is None:
            printable = {
                k: (v if isinstance(v, (float, int, str)) else f"<{type(v).__name__}>")
                for k, v in data.items()
            }
            self.log(f"METRICS: {printable}")
            return
        step = (opts.wandb_global_step or 0) + 1
        wandb.log(data, step=step)
        opts.wandb_global_step = step

    # -------------------------------------------- wandb session lifecycle

    def __enter__(self) -> "ExpEnv":
        opts = self._get_logger_opts(self.config)
        flattened = self.config.flatten_dump()
        self.log("CONFIG: " + json.dumps(flattened, indent=2))
        wandb = _try_wandb()
        if opts is None or not opts.wandb_enabled or wandb is None:
            return self
        wandb.init(
            id=opts.wandb_run_id,
            project=opts.wandb_project,
            name=opts.wandb_name,
            config=flattened,
            resume="allow",
        )
        if wandb.run is not None:
            opts.wandb_run_id = wandb.run.id
            self.flush_cfg()  # persist the run id for resumption
        self.log(
            f"[[[ wandb enabled: {opts.wandb_project} / {opts.wandb_name} / "
            f"{opts.wandb_run_id} ]]]"
        )
        return self

    def __exit__(self, *args) -> None:
        opts = self._get_logger_opts(self.config)
        wandb = _try_wandb()
        if opts is not None and opts.wandb_enabled and wandb is not None:
            if wandb.run is not None:
                wandb.run.finish()
                self.log("[[[ wandb finished ]]]")

    def flush_cfg(self) -> None:
        """Rewrite .hparams.json in place (indented, aliased field names)."""
        raw = self.config.to_dict(exclude_unset=True)
        (self.model_path / ".hparams.json").write_text(
            json.dumps(raw, indent=2) + "\n", "utf-8"
        )
        self.log("[i] updated config file")
