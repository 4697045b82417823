"""Terminal/log output: ANSI-formatted, width-wrapped, nested 'done'
messages — counterpart of reference commons.py:734-1034 (fancyprint,
masterprint, warn, abort).

Single-controller JAX has one host process, so 'master-only' printing is
trivial; the formatting surface (nesting, wrapping, suppression regexes)
is preserved.
"""

from __future__ import annotations

import os
import re
import sys
import textwrap
import time

_indent_level = 0
_start_times: list[float] = []
_suppress_patterns: list[re.Pattern] = []
_enable_formatting = sys.stdout.isatty()
terminal_width = int(os.environ.get("COLUMNS", 80))


def set_suppress_output(patterns):
    global _suppress_patterns
    _suppress_patterns = [re.compile(p) for p in patterns]


def set_formatting(enabled: bool):
    """Toggle ANSI escapes in all output (reference
    enable_terminal_formatting, param/example_explanatory:539)."""
    global _enable_formatting
    _enable_formatting = bool(enabled)


def _suppressed(msg: str) -> bool:
    return any(p.search(msg) for p in _suppress_patterns)


def masterprint(*args, indent: int | None = None, wrap: bool = True, **kwargs):
    """Print with nesting: a message ending in '...' opens a nested scope
    closed by masterprint('done') which reports the elapsed time
    (reference masterprint semantics, commons.py:989)."""
    global _indent_level
    msg = " ".join(str(a) for a in args)
    if _suppressed(msg):
        return
    if msg == "done":
        if _start_times:
            dt = time.time() - _start_times.pop()
            _indent_level = max(0, _indent_level - 1)
            pad = "    " * _indent_level
            print(f"{pad}done ({format_time(dt)})", **kwargs)
        return
    pad = "    " * _indent_level
    text = pad + msg
    if wrap and len(text) > terminal_width:
        text = textwrap.fill(
            msg, terminal_width, initial_indent=pad, subsequent_indent=pad + "    "
        )
    print(text, **kwargs)
    if msg.rstrip().endswith("..."):
        _indent_level += 1
        _start_times.append(time.time())


def masterwarn(*args, **kwargs):
    msg = " ".join(str(a) for a in args)
    prefix = "\033[1;91mWarning\033[0m" if _enable_formatting else "Warning"
    print(f"{prefix}: {msg}", file=sys.stderr, **kwargs)


warn = masterwarn  # reference name (commons.py:968)


def abort(*args, exit_code: int = 1):
    msg = " ".join(str(a) for a in args)
    prefix = "\033[1;91mAborting\033[0m" if _enable_formatting else "Aborting"
    print(f"{prefix}: {msg}", file=sys.stderr)
    sys.exit(exit_code)


def format_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds*1e6:.0f} µs"
    if seconds < 1:
        return f"{seconds*1e3:.0f} ms"
    if seconds < 60:
        return f"{seconds:.1f} s"
    m, s = divmod(seconds, 60)
    if m < 60:
        return f"{int(m)} m {s:.0f} s"
    h, m = divmod(m, 60)
    return f"{int(h)} h {int(m)} m"
