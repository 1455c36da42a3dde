"""The operation and byte counts at a shape small enough to work out by
hand (multiply-adds x 2)."""

from harness import flops

TINY = {"hidden_channels": 2, "filter_channels": 4, "inter_channels": 2,
        "n_heads": 1, "n_layers": 1, "kernel_size": 3,
        "upsample_initial_channel": 8, "upsample_rates": [2],
        "upsample_kernel_sizes": [4], "resblock": "2",
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 2]]}


def test_text_encoder_by_hand():
    # q, k, v, o: 4 x 2*3*2*2; scores and context 2 x 2*3*3*2; relative
    # keys and values 2 x 2*3*9*2; the FFN 2 x 2*3*4*(2*3); proj 2*3*4*2
    assert flops.text_encoder(TINY, 3) == 96 + 72 + 216 + 288 + 48


def test_flow_by_hand():
    # per coupling: pre 2*5*2*1, 4 WN layers of (2*5*4*10 + 2*5*4*2), post
    # 2*5*1*2; four couplings
    assert flops.flow(TINY, 5) == 4 * (20 + 4 * (400 + 80) + 20)
    assert flops.flow_bytes(TINY, 5) == 2 * 5 * 2 * 4


def test_stage_group_by_hand():
    # one stage at 10 samples of 4 channels: 2 convs of kernel 3, each
    # 2*10*4*12; the tail conv_post 2*10*1*(4*7)
    assert flops.stage_group(TINY, 5) == 2 * 960 + 560
    # the stage's input and output, 10 x 4 floats each, and the audio out
    assert flops.stage_group_bytes(TINY, 5) == (2 * 10 * 4 + 10) * 4
    # two convs' weights and biases, and conv_post's 7 x 4
    assert flops.stage_group_weight_bytes(TINY) == (2 * (4 * 4 * 3 + 4)
                                                    + 28) * 4


def test_decoder_by_hand():
    # conv_pre 2*5*8*(2*7), the transposed conv 2*5*4*(8*4), the group
    assert flops.decoder(TINY, 5) == 1120 + 1280 + 2480


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(10.0, 1.0, 5.0, 1.0) == 2.0
    assert flops.least_seconds(1.0, 30.0, 5.0, 10.0) == 3.0
