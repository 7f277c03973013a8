"""The operation and byte counters against hand counts at small widths."""
from portbench import flops
from portbench.weights import implicit_shapes, render_shapes

# SDF: PE of 1 frequency (3 * 3 = 9 wide), hidden 16 x 3 with the encoded
# input again before layer 2 (layer 1 gives 16 - 9 = 7), out 1 + 1 + 2
# features
ICFG = {"dims": [16, 16, 16], "multires": 1, "skip_in": [2], "d_out": 1,
        "feature_vector_size": 2}
RCFG = {"dims": [5], "d_in": 9, "d_out": 3, "feature_vector_size": 2,
        "multires_view": 1}


def test_shapes():
    assert implicit_shapes(ICFG) == [(9, 16), (16, 7), (16, 16), (16, 4)]
    # radiance input: 9 + 2 features + PE(view) 9 - 3 = 17
    assert render_shapes(RCFG) == [(17, 5), (5, 3)]


def test_sdf_mlp_cost_by_hand():
    icfg = ICFG
    macs = 9 * 16 + 16 * 7 + 16 * 16 + 16   # the SDF column of the last
    assert flops.sdf_column_macs(icfg) == macs
    ops, nbytes = flops.sdf_mlp_cost(icfg, 10)
    assert ops == 2 * macs * 10
    weights = (9 * 16 + 16) + (16 * 7 + 7) + (16 * 16 + 16) + 16 + 1
    assert nbytes == 4 * (10 * 9 + 10 + weights)


def test_bound_takes_the_larger():
    assert flops.bound_s(989e12, 0) == 1.0
    assert flops.bound_s(0, 3.35e12) == 1.0
    assert flops.bound_s(989e12, 6.7e12) == 2.0


def test_step_flops_by_hand():
    icfg = ICFG
    full = 9 * 16 + 16 * 7 + 16 * 16 + 16 * 4
    col = 9 * 16 + 16 * 7 + 16 * 16 + 16
    rad = 17 * 5 + 5 * 3
    B, P, rows, hits = 2, 8, 100, 5
    got = flops.step_flops(icfg, RCFG, B, P, rows, hits, dsurf=False,
                           detach_geometry=False)
    assert got == 2 * col * rows + 12 * full * (hits + 8) + \
        (12 * full + 6 * rad) * hits
    got_a = flops.step_flops(icfg, RCFG, B, P, rows, hits, dsurf=True,
                             detach_geometry=True)
    assert got_a == 2 * col * rows + 12 * full * (hits + 8 + 16) + \
        (8 * full + 6 * rad) * hits


def test_full_width_sdf_mlp_bound_matches_the_kernel_table():
    icfg = {"dims": [512] * 8, "multires": 6, "skip_in": [4], "d_out": 1,
            "feature_vector_size": 256}
    ops, nbytes = flops.sdf_mlp_cost(icfg, 65537)
    assert abs(flops.bound_s(ops, nbytes) * 1e3 - 0.2433) < 1e-3
    ops, nbytes = flops.sdf_mlp_cost(icfg, 2097152)
    assert abs(flops.bound_s(ops, nbytes) * 1e3 - 7.784) < 1e-2
