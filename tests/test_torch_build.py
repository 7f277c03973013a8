"""The kernels' library is named by everything it is built from: an edit to
any CUDA file under ``csrc/`` (a kernel source or a shared header) names a
new library, so a stale build is never loaded; the host C++ triangulator is
its own library, named by its source, and so is the mesh trimming's
max-flow. Checked on a copy of the sources; no compiler is needed. All land
in ``_build/``, which git ignores."""
import os
import shutil

from mvsdf_tpu_torch.tracing.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_FILES = ["graph_cond.cu", "march.cu", "mlp_tile_tc.cuh",
              "png_unfilter.cu", "sdf_mlp.cu", "secant.cu", "softplus100.cu",
              "stamp.cu"]
HOST_FILES = ["jpeg.cpp", "marching_tets.cpp", "maxflow.cpp"]


def test_library_path_follows_every_file_under_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = sorted(p.name for p in csrc.iterdir())
    assert names == sorted(CUDA_FILES + HOST_FILES)
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
    """An edit to a host source (the triangulator, the max-flow) names a
    new library for it alone and leaves the kernels' library and the other
    host library as they were; an edit to a kernel leaves the host
    libraries."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    out = str(tmp_path / "_build")
    host = {name: build.host_library_path(name, str(csrc), out)
            for name in HOST_FILES}
    assert os.path.basename(host["marching_tets.cpp"]).startswith(
        "libmarching_tets_")
    assert os.path.basename(host["maxflow.cpp"]).startswith("libmaxflow_")
    assert os.path.basename(host["jpeg.cpp"]).startswith("libjpeg_")
    for name in HOST_FILES:
        cuda = build.library_path(str(csrc), out)
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        edited = build.host_library_path(name, str(csrc), out)
        assert edited != host[name]
        assert build.library_path(str(csrc), out) == cuda
        for other in HOST_FILES:
            if other != name:
                assert build.host_library_path(other, str(csrc),
                                               out) == host[other]
        host[name] = edited
    cuda = build.library_path(str(csrc), out)
    with open(csrc / "sdf_mlp.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(str(csrc), out) != cuda
    for name in HOST_FILES:
        assert build.host_library_path(name, str(csrc), out) == host[name]


def test_build_directory_is_ignored_by_git():
    rel = os.path.relpath(build.BUILD_DIR, REPO).replace(os.sep, "/") + "/"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel in f.read().split()
    for name in HOST_FILES:
        assert os.path.dirname(build.host_library_path(
            name)) == build.BUILD_DIR
