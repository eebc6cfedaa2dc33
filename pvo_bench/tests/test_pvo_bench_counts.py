"""The frozen bounds and the work count against cases worked by hand."""

from pvo_bench import bounds


def test_k1_bound_two_by_two():
    # E=1 edge of 2x2 bf16 features: levels 4 + 1 + 0 + 0 = 5 columns,
    # padded to 64; inputs 2 maps x 4 px x 128 ch x 2 B = 2048 B, the
    # volume 4 px x 64 x 2 B = 512 B; 4 px x 5 x 128 ch x 2 = 5120 flops
    b = bounds.corr_bound("build_volumes", 1, 2, 2)
    assert b["bytes"] == 2048 + 512
    assert b["flops"] == 5120
    assert b["ms"] == max(1e3 * 2560 / 3.35e12, 1e3 * 5120 / 989e12)


def test_k2_k3_bounds_one_pixel():
    # one pixel: K2 reads 4 levels x 64 taps x 2 B + coords 8 B, writes
    # 4 x 49 x 4 B; K3 reads both maps' 128 channels (bf16) + coords
    k2 = bounds.corr_bound("corr_extract", 1, 1, 1)
    assert k2["bytes"] == 512 + 8 + 784
    assert k2["flops"] == 4 * 49 * 7
    k3 = bounds.corr_bound("corr_lookup", 1, 1, 1, "f32")
    assert k3["bytes"] == 2 * 128 * 4 + 8 + 784
    assert k3["flops"] == 4 * 64 * 128 * 2


def test_dba_bounds_small():
    s = bounds.dba_bound("dba_solve", P=1)
    # M = 6: two 6x6 systems and two 6-vectors read, dx written
    assert s["bytes"] == 2 * (36 + 6) * 4 + 6 * 4
    assert s["flops"] == 6 ** 3 // 3 + 3 * 36
    lin = bounds.dba_bound("dba_linearize", E=1, HW=1)
    assert lin["bytes"] == (5 + 14) * 4 + 17 + 156 * 4 + 14 * 4
    assert lin["flops"] == 816 + 54


def test_operator_flops_one_pixel():
    # multiply-adds at one pixel: corr encoder 196*128 + 9*128*128,
    # flow encoder 49*8*128 + 9*128*64, GRU 3 * 9*448*128 + 128*128,
    # heads 4 * (9*128*128 + 9*128*2), GraphAgg's conv 9*128*128
    macs = (196 * 128 + 9 * 128 * 128 + 49 * 8 * 128 + 9 * 128 * 64 +
            3 * 9 * 448 * 128 + 128 * 128 + 4 * (9 * 128 * 128 + 9 * 128 * 2)
            + 9 * 128 * 128)
    assert macs == 2607616
    assert bounds.operator_flops(1, 1) == 2 * macs


def test_encoder_flops_8x8():
    # 8x8 input: 4x4 after the stride-2 7x7 conv, 2x2, then 1x1
    macs = (3 * 32 * 49 * 16 + 4 * 32 * 32 * 9 * 16 +
            32 * 64 * 9 * 4 + 3 * 64 * 64 * 9 * 4 + 32 * 64 * 4 +
            64 * 128 * 9 + 3 * 128 * 128 * 9 + 64 * 128 + 128 * 128)
    assert bounds.encoder_flops(8, 8, 128) == 2 * macs == 3460096


def test_frame_count_adds_up():
    h, w = 30, 101
    f = bounds.track_frame_flops(240, 808, 48, 6, True)
    probe = bounds.volume_flops(h, w) + bounds.operator_flops(h, w) + \
        bounds.lookup_flops(h, w)
    upd = 48 * bounds.volume_flops(h, w) + 6 * (
        48 * (bounds.operator_flops(h, w) + bounds.lookup_flops(h, w)) +
        2 * (48 * (816 * h * w + 54) + 96 * 48 * h * w))
    assert f == bounds.frame_encode_flops(240, 808) + probe + upd
    assert bounds.track_frame_flops(240, 808, 48, 6, False) == \
        bounds.frame_encode_flops(240, 808) + probe
