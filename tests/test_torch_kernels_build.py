"""The kernel library's build digest, on the CPU (no nvcc): it must change
with any file under ``csrc/`` (a header included) and with the flags, so an
edit never loads a stale library."""

import shutil

from sd_video_gen_tpu_torch.ops import _kernels


def test_digest_covers_every_source_header_and_flag(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    base = _kernels.source_digest(csrc)
    assert base == _kernels.source_digest(csrc)          # deterministic
    assert len(base) == 16
    assert base == _kernels.source_digest(_kernels.CSRC) == \
        _kernels.source_digest()

    header = csrc / "common.cuh"
    header.write_text("#pragma once\n")
    with_header = _kernels.source_digest(csrc)
    assert with_header != base                            # a new header
    header.write_text("#pragma once\n// edited\n")
    edited = _kernels.source_digest(csrc)
    assert edited not in (base, with_header)              # an edited header
    (csrc / "sub").mkdir()
    (csrc / "sub" / "tile.h").write_text("#define TILE 64\n")
    nested = _kernels.source_digest(csrc)
    assert nested != edited                               # a nested .h

    flags = _kernels.NVCC_FLAGS + ("-lineinfo",)
    assert _kernels.source_digest(csrc, flags) != nested  # a flag
    assert _kernels.source_digest(csrc, _kernels.NVCC_FLAGS) == nested
