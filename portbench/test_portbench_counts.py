"""The yardstick's counts against hand counts at small shapes."""

import math

from portbench import counts


def test_forward_flop_and_bytes_by_hand():
    # 2 docs of 5 words, E=3, F=4, W=3: 5 + 2 = 7 window starts, each a
    # 3*3 = 9-term dot product per filter: 2 * 7 * 4 * 9 multiply-adds
    assert counts.textcnn_fwd_flop(2, 5, 3, 4, 3) == 2 * (2 * 7 * 4 * 9)
    # docs 2*5*3, K 3*3*4, b 4, out and idx 2*4 each, 4 bytes a value
    assert counts.textcnn_fwd_bytes(2, 5, 3, 4, 3) == 4 * (30 + 36 + 4 + 16)


def test_forward_bound_is_the_larger_of_the_two():
    n, t, e, f, w = 256, 1000, 64, 100, 3
    flop_s = counts.textcnn_fwd_flop(n, t, e, f, w) / counts.PEAK_FLOPS
    byte_s = counts.textcnn_fwd_bytes(n, t, e, f, w) / counts.HBM_BYTES_S
    assert counts.textcnn_fwd_bound_s(n, t, e, f, w) == max(flop_s, byte_s)
    # deepconn's training launch is bound by its operations, 19.9 us
    assert math.isclose(flop_s, 1.99e-5, rel_tol=0.01) and flop_s > byte_s


CFG = {"model": "deepconn", "num_filters": 2, "window": 2, "fm_factors": 3,
       "hp": {"input_length": 4, "word_embed_size": 3, "latent_size": 2}}


def test_train_flop_per_example_by_hand():
    # a tower's conv: 4 + 1 = 5 starts x 2 filters x (2*3 = 6 terms):
    # 120 FLOP; two towers 240. dK over the winning windows: 2 filters x
    # 6 terms x 2 FLOP = 24 a tower, 48. Dense layers, 3x their forward
    # for forward and backward: fc 2 x (2*2*2 + 2) = 20; the FM over
    # n = 4 with k = 3: 2 x (2*4*3 + 3) + 3*3 + 2*4 + (2*4 + 1) = 80
    assert counts.train_flop_per_example(CFG) == 240 + 48 + 3 * (20 + 80)


def test_rank_flop_counts_each_tower_once_a_call():
    tower = 120 + (2 * 2 * 2 + 2)
    head = 80
    assert counts.rank_flop(CFG, users=3, items=5, pairs=15) == (
        8 * tower + 15 * head)


def test_peak_is_dense_tf32_and_its_reason_is_given():
    assert counts.PEAK_FLOPS == 495e12
    assert "TF32" in counts.__doc__ and "67 TFLOP/s" in counts.__doc__
