"""A training run's log file (counterpart of
gen_adversarial_tpu/core/runlog.py): `RunLog` is a log_fn that tees each
line to another (print by default) and appends it to `<out>/log.txt` as it
arrives, so a killed run leaves its log; `param_summary` is the one-line
parameter count printed at startup.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

from torch import nn


class RunLog:
    """Callable log_fn that tees to `log_fn` (default print) and, when
    `path` is set, appends each line to the log file as it arrives."""

    def __init__(self, path: str | Path | None = None, log_fn=print,
                 append: bool = False):
        self._fn = log_fn
        self.lines: list[str] = []
        self.path = Path(path) if path is not None else None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if not (append and self.path.exists()):
                self.path.write_text("")  # fresh run, fresh log

    def __call__(self, line):
        line = str(line)
        self.lines.append(line)
        self._fn(line)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_summary(params, name: str = "model") -> str:
    """One-line parameter count of a module's parameters or of a flax
    params tree (the same arrays: a BatchNorm's weight and bias are flax's
    scale and bias)."""
    leaves = list(params.parameters()) if isinstance(params, nn.Module) else list(_leaves(params))
    n = sum(int(x.numel() if hasattr(x, "numel") else x.size) for x in leaves)
    return f"{name}: {n:,} parameters in {len(leaves)} arrays"
