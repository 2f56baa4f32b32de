"""``tools/resume_check.py`` on the CPU at a small size: the saving process's
second step and two restored ones (here in this process, one after another)
equal bit for bit; a perturbed state shows in ``compare``. On the card it
runs ``train_ref_artifact`` at its batch of 64 in three fresh processes."""
import torch

from sd_video_gen_tpu_torch.tools import resume_check as R


def test_restored_steps_equal_the_uninterrupted_one(tmp_path):
    for role in ("first", "resumed_1", "resumed_2"):
        R.child(role, str(tmp_path), batch=1, frame=16, device="cpu")
    states = {n: torch.load(tmp_path / f"{n}.pt", weights_only=True)
              for n in ("uninterrupted", "resumed_1", "resumed_2")}
    out = R.compare(states)
    assert out["steps"] == 2
    assert out["equal"] == {"resumed_1": True, "resumed_2": True}
    assert all(d == 0.0 for v in out["max_abs_diff"].values()
               for d in v.values())
    k = next(iter(states["resumed_1"]["mu"]))
    states["resumed_1"]["mu"][k] = states["resumed_1"]["mu"][k] + 1e-3
    out = R.compare(states)
    assert out["equal"] == {"resumed_1": False, "resumed_2": True}
    assert abs(out["max_abs_diff"]["resumed_1"]["mu"] - 1e-3) < 1e-6
