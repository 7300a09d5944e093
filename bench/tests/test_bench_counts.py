"""The benchmark's counts of the work against numbers worked by hand on a
tiny tree."""
import numpy as np

from bench.counts import flops, gather_bytes


def test_sage_iteration_flops_by_hand():
    # 2 roots, fanout 3, 2 layers, d 4 -> hidden 5 -> 6 classes.
    # hops: 2, 6, 18 nodes. Layer 0 updates hops 0..1 (8 parents), two
    # products each 2*8*4*5 = 320 -> forward 640; backward needs dW only
    # (its X are feature rows): 640. Layer 1 updates hop 0 (2 parents):
    # 2 * (2*2*5*5) = 200 forward, 400 backward. Head 2*2*5*6 = 120,
    # times 3 with its backward.
    model = {"kind": "sage", "num_layers": 2, "hidden_dim": 5, "fanout": 3}
    assert flops.iteration(model, 4, 6, 2) == 640 + 640 + 200 + 400 + 360


def test_gat_iteration_flops_by_hand():
    # as above with GAT (2 heads of 2.5 are not allowed: hidden 4, 2 heads).
    # Layer 0: hops 0..2 projected once, 26 rows * 2*4*4 = 832; attention:
    # 2*4*(2*8 + 24 children) = 320, plus the weighted sum over 3+1 terms
    # at 8 parents 2*8*4*4 = 256; forward 1408, backward 2*1408 - 832.
    # Layer 1: hops 0..1 projected, 8 rows * 2*4*4 = 256; attention
    # 2*4*(2*2 + 6) = 80 and 2*2*4*4 = 64; forward 400, backward 800.
    # Head 2*2*4*6 = 96, times 3.
    model = {"kind": "gat", "num_layers": 2, "hidden_dim": 4, "heads": 2,
             "fanout": 3}
    layer0 = 832 + 320 + 256
    layer1 = 256 + 80 + 64
    assert flops.iteration(model, 4, 6, 2) == (3 * layer0 - 832
                                                 + 3 * layer1 + 3 * 96)


def test_gather_bytes_by_hand():
    # hop 0: 2 nodes, 2 distinct; hop 1: 4 nodes, 3 distinct; d 8 floats.
    hops = [np.array([1, 2]), np.array([3, 3, 4, 5])]
    per_node = 8 * 4 + 4
    assert gather_bytes.tree_bytes(hops, 8) == \
        (2 + 4) * per_node + (2 + 3) * 8 * 4
