"""The kernels' library is named by everything it is built from: an edit to
any CUDA file under ``csrc/`` (a kernel source or a shared header) names a
new library, so a stale build is never loaded; the host C++ triangulator is
its own library, named by its source. Checked on a copy of the sources; no
compiler is needed. Both land in ``_build/``, which git ignores."""
import os
import shutil

from mvsdf_tpu_torch.tracing.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_FILES = ["march.cu", "mlp_tile_tc.cuh", "png_unfilter.cu", "sdf_mlp.cu",
              "secant.cu"]


def test_library_path_follows_every_file_under_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = sorted(p.name for p in csrc.iterdir())
    assert names == sorted(CUDA_FILES + ["marching_tets.cpp"])
    out = str(tmp_path / "_build")
    seen = {build.library_path(str(csrc), out)}
    assert build.library_path(str(csrc), out) in seen  # stable
    assert build.library_path() == build.library_path(build.CSRC)
    for name in CUDA_FILES:
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        path = build.library_path(str(csrc), out)
        assert path not in seen, name
        seen.add(path)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(str(csrc), out) not in seen


def test_host_library_path_follows_its_source_only(tmp_path):
    """An edit to the triangulator names a new host library and leaves the
    kernels' library as it was; an edit to a kernel leaves the host
    library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    out = str(tmp_path / "_build")
    host = build.host_library_path("marching_tets.cpp", str(csrc), out)
    cuda = build.library_path(str(csrc), out)
    assert os.path.basename(host).startswith("libmarching_tets_")
    with open(csrc / "marching_tets.cpp", "a") as f:
        f.write("\n// edited\n")
    assert build.host_library_path("marching_tets.cpp", str(csrc),
                                   out) != host
    assert build.library_path(str(csrc), out) == cuda
    with open(csrc / "sdf_mlp.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(str(csrc), out) != cuda
    assert build.host_library_path("marching_tets.cpp", str(csrc),
                                   out) != host   # its own edit only


def test_build_directory_is_ignored_by_git():
    rel = os.path.relpath(build.BUILD_DIR, REPO).replace(os.sep, "/") + "/"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel in f.read().split()
    assert os.path.dirname(build.host_library_path(
        "marching_tets.cpp")) == build.BUILD_DIR
