"""ANSI console color constants + minimal styled logging helpers.

Parity with `PointCloudProcessor/include/vlcal/common/console_colors.hpp`
(the reference's ANSI escape constants), plus small helpers the reference
scatters as raw `std::cout` color prints. Colors auto-disable when stdout is
not a TTY (or NO_COLOR is set).

A copy of `pointcloudprocessor_tpu/utils/console.py`."""

from __future__ import annotations

import os
import sys

_ENABLED = sys.stdout.isatty() and not os.environ.get("NO_COLOR")


def _c(code: str) -> str:
    return code if _ENABLED else ""


RESET = _c("\033[0m")
BOLD = _c("\033[1m")
UNDERLINE = _c("\033[4m")

BLACK = _c("\033[30m")
RED = _c("\033[31m")
GREEN = _c("\033[32m")
YELLOW = _c("\033[33m")
BLUE = _c("\033[34m")
MAGENTA = _c("\033[35m")
CYAN = _c("\033[36m")
WHITE = _c("\033[37m")

BRIGHT_RED = _c("\033[91m")
BRIGHT_GREEN = _c("\033[92m")
BRIGHT_YELLOW = _c("\033[93m")


def info(msg: str) -> None:
    print(f"{GREEN}{msg}{RESET}")


def warn(msg: str) -> None:
    print(f"{YELLOW}warning:{RESET} {msg}", file=sys.stderr)


def error(msg: str) -> None:
    print(f"{BRIGHT_RED}error:{RESET} {msg}", file=sys.stderr)
