"""``BENCHMARK.json`` built from the benchmark's files.

    python3 -m benchmark.manifest            # print it
    python3 -m benchmark.manifest --write    # write it at the repo root
    python3 -m benchmark.manifest --check    # exit 1 where it differs

Every entry comes from a file of its own (``harness.py``), so a later cell,
configuration or metric is new files and this run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from benchmark import harness

ROOT = harness.HERE.parent


def build(root: Path = harness.HERE) -> dict:
    settings = json.loads((root / "settings.json").read_text())
    rel = root.relative_to(root.parent)
    configs = [{"name": n, "source": c["source"],
                "file": f"{rel}/configs/{n}.json", "reduced": c["reduced"],
                "why": c["why"]} for n, c in harness.configs(root).items()]
    cells = [{"name": n, "config": c["config"], "traffic": c["traffic"],
              "chips": c["chips"], "why": c["why"]}
             for n, c in harness.cells(root).items()]
    e2e = []
    for n, m in harness.end_to_end(root).items():
        entry = {"name": n, "unit": m["unit"], "better": m["better"],
                 "bound": m["bound"], "source": m["source"]}
        if "workloads" in m:
            entry["workloads"] = harness.reporters(n, m["workloads"], root)
        e2e.append(entry)
    layers = [{"name": m.name, "unit": m.unit, "better": m.better,
               "source": m.source, "layer": m.layer, "moves": m.moves,
               "workloads": harness.reporters(m.name, m.workloads, root)}
              for m in harness.per_layer(root).values()]
    return {"command": settings["command"], "paths": settings["paths"],
            "run_seconds": settings["run_seconds"], "configs": configs,
            "workloads": cells, "end_to_end": e2e, "per_layer": layers}


def text(root: Path = harness.HERE) -> str:
    return json.dumps(build(root), indent=2) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = text()
    path = ROOT / "BENCHMARK.json"
    if "--write" in argv:
        path.write_text(out)
    elif "--check" in argv:
        if not path.exists() or path.read_text() != out:
            print("BENCHMARK.json differs from benchmark/'s files",
                  file=sys.stderr)
            return 1
    else:
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
