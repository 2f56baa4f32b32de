"""Faults the CPU tests plant under the timed path, by name: in the test's
process with ``monkeypatch``, and in a run's other ranks by starting them
through this module, which plants the fault and then runs the training
driver's rank:

    python3 -m benchmark.tests.faults <fault> --spec ... --rank ...
"""

from __future__ import annotations

import sys


def plant(name: str, setattr_=setattr) -> None:
    if name == "no_exchange":
        from sd_video_gen_tpu_torch.parallel import multihost
        setattr_(multihost, "all_reduce_mean", lambda *a, **k: None)
    else:
        raise ValueError(f"unknown fault {name!r}")


def worker(name: str) -> list:
    """The command that starts a rank with the fault ``name`` planted."""
    return [sys.executable, "-m", "benchmark.tests.faults", name]


if __name__ == "__main__":
    plant(sys.argv[1])
    from benchmark.drivers import train
    sys.exit(train.main(sys.argv[2:]))
