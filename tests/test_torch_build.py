"""The kernels' library is named by everything it is built from: an edit to
any file under ``csrc/`` (a kernel source or a shared header) names a new
library, so a stale build is never loaded. Checked on a copy of the
sources; no compiler is needed."""
import shutil

from mvsdf_tpu_torch.tracing.kernels import build


def test_library_path_follows_every_file_under_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = sorted(p.name for p in csrc.iterdir())
    assert names == ["march.cu", "mlp_tile_tc.cuh", "png_unfilter.cu",
                     "sdf_mlp.cu", "secant.cu"]
    out = str(tmp_path / "_build")
    seen = {build.library_path(str(csrc), out)}
    assert build.library_path(str(csrc), out) in seen  # stable
    assert build.library_path() == build.library_path(build.CSRC)
    for name in names:
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        path = build.library_path(str(csrc), out)
        assert path not in seen, name
        seen.add(path)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(str(csrc), out) not in seen
