"""The port's UCF loader tool (``sd_video_gen_tpu_torch/tools/
bench_ucf_loader.py``) against the JAX tool (``tools/bench_ucf_loader.py``)
on the same shrunk tree (3 videos of 30 frames at 32px): the same printed
keys and the same clip count. Rates are the host's: only their sign is
checked."""

import importlib
import json

from sd_video_gen_tpu_torch.tools import bench_ucf_loader as U

SHRUNK = dict(N_VIDEOS=3, FRAMES=30, SIZE=32)


def test_prints_the_jax_tools_keys_and_clips(tmp_path, monkeypatch, capsys):
    jax_tool = importlib.import_module("tools.bench_ucf_loader")
    for name, value in SHRUNK.items():
        monkeypatch.setattr(jax_tool, name, value)
    jax_tool.main()
    theirs = json.loads(capsys.readouterr().out.splitlines()[-1])
    mine = U.run(str(tmp_path), SHRUNK["N_VIDEOS"], SHRUNK["FRAMES"],
                 SHRUNK["SIZE"])
    assert set(mine) == set(theirs)
    assert mine["clips"] == theirs["clips"] > 0
    assert all(v > 0 for v in mine.values())


def test_tree_is_the_jax_tools(tmp_path, monkeypatch):
    """The same files, byte for byte, and the same split lists."""
    jax_tool = importlib.import_module("tools.bench_ucf_loader")
    for name, value in SHRUNK.items():
        monkeypatch.setattr(jax_tool, name, value)
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir(), b.mkdir()
    jax_tool.build_tree(str(a))
    U.build_tree(str(b), SHRUNK["N_VIDEOS"], SHRUNK["FRAMES"],
                 SHRUNK["SIZE"])
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert len(files) == SHRUNK["N_VIDEOS"] + 2
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
