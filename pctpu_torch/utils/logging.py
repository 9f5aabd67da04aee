"""Console logging matching the reference's output style (ANSI colors,
``[TIME]`` lines — reference/BatchTopPartRegistration.cpp:38-40)."""

from __future__ import annotations

import sys

COLOR_RESET = "\033[0m"
COLOR_GREEN = "\033[32m"
COLOR_RED = "\033[31m"


def info(msg: str) -> None:
    print(msg)


def green(msg: str) -> None:
    print(f"{COLOR_GREEN}{msg}{COLOR_RESET}")


def red(msg: str) -> None:
    print(f"{COLOR_RED}{msg}{COLOR_RESET}")



def error(msg: str) -> None:
    print(msg, file=sys.stderr)
