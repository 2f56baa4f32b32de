"""Run one of the port's CLIs with its kernel launches counted, for a parent
process that has to account for what its children launched.

    python -m sd_video_gen_tpu_torch.tools.counted <module> [argv ...]

imports ``<module>`` (e.g. ``sd_video_gen_tpu_torch.predict.predict``) and
calls its ``main(argv)`` inside one launch window
(``tools/bench_harness.launch_window``: ``_kernels.LAUNCHES`` and both
dispatchers' launches by body, set to 0 on entry and read on exit) and a
``_kernels.record_calls`` (every dispatcher call, kernel or plain version).
Nothing else changes: the CLI computes what it computes without the runner.
When ``main`` returns, one line

    COUNTED {"launches": {kernel: n}, "bodies": {kernel: {body: n}},
             "calls": {kernel: n}}

is printed and flushed. The exit code is ``main``'s where it returns an
int, else 0; a CLI that raises prints its traceback and exits 1, with no
``COUNTED`` line.
"""

from __future__ import annotations

import collections
import importlib
import json
import sys

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.tools.bench_harness import launch_window

PREFIX = "COUNTED "


def run(module: str, argv: list) -> tuple:
    """``module.main(argv)``'s return value and its counts."""
    main = importlib.import_module(module).main
    with launch_window() as window, _kernels.record_calls() as rec:
        ret = main(argv)
    calls = collections.Counter()
    for (name, _), n in rec.calls.items():
        calls[name] += n
    return ret, {"launches": window.launches,
                 "bodies": {"flash_attention": window.bodies,
                            "groupnorm_silu": window.gn_bodies},
                 "calls": dict(calls)}


def command(module: str, counted: bool) -> list:
    """The interpreter's command line that runs ``module`` as a script,
    through this runner when ``counted``."""
    return [sys.executable, "-m", *((__name__,) if counted else ()), module]


def parse(lines) -> dict:
    """The counts of a child's output lines (the last ``COUNTED`` line);
    raises where there is none."""
    found = [ln for ln in lines if ln.startswith(PREFIX)]
    if not found:
        raise RuntimeError("the child printed no COUNTED line")
    return json.loads(found[-1][len(PREFIX):])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    ret, counts = run(argv[0], argv[1:])
    print(PREFIX + json.dumps(counts), flush=True)
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
