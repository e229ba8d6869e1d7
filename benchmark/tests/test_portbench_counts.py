"""The benchmark's frozen counts against hand counts and against
``torch.utils.flop_counter`` on the reference net, at small sizes on the
CPU."""

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH)]

import counts  # noqa: E402
from reference import nets  # noqa: E402

SMALL = {"img_size": 64, "tabular_embedding_dim": 32,
         "tabular_transformer_num_layers": 2, "multimodal_embedding_dim": 32,
         "multimodal_transformer_num_layers": 1, "projection_dim": 8,
         "num_classes": 5, "target": "dvm",
         "field_lengths": [3, 4, 1, 1, 1]}


def test_bn_bytes_match_the_recorded_pass_at_batch_512():
    # PERF.md's bound arithmetic: 3.716 GB a forward pass of bn_stats and
    # 7.433 GB a backward pass of bn_bwd_reduce at batch 512, 128 x 128
    shapes = counts.bn_shapes(512, 128)
    assert len(shapes) == 53
    assert shapes[0] == (512 * 64 * 64, 64)
    assert shapes[-1] == (512 * 4 * 4, 2048)
    assert counts.bn_stats_bytes(512, 128) == 3_716_153_344
    assert counts.bn_bwd_reduce_bytes(512, 128) == 7_432_306_688


def test_resnet50_flops_match_the_published_count():
    # ResNet-50's convolutions at 224 x 224: 4.09 G multiply-adds
    assert counts.image_tower_flops(1, 224) == 8_174_272_512
    assert counts.stage4_size(128) == 4


def test_tabular_block_by_hand():
    m = dict(SMALL, tabular_transformer_num_layers=1)
    b, t, d = 2, 6, 32          # 5 fields + CLS
    block = 2 * b * t * (d * 3 * d + d * d + 2 * d * 4 * d) + 4 * b * t * t * d
    assert counts.tabular_flops(b, m) == 2 * b * 3 * d + block


@pytest.mark.parametrize("target", ["dvm", "CAD"])
def test_forward_flops_match_the_flop_counter(target):
    m = dict(SMALL, target=target)
    net = nets.STiLNet(m).eval()
    b = 2
    images = torch.rand(b, m["img_size"], m["img_size"], 3)
    tab = torch.cat([torch.randint(0, 3, (b, 2)).float(),
                     torch.randn(b, 3)], 1)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            net.model.encoder_imaging(images)
        assert fc.get_total_flops() == counts.image_tower_flops(
            b, m["img_size"])
        with FlopCounterMode(display=False) as fc:
            net.model(images, tab)
        assert fc.get_total_flops() == counts.backbone_flops(b, m)
        with FlopCounterMode(display=False) as fc:
            net(images, tab)
        assert fc.get_total_flops() == counts.stil_forward_flops(b, m)


def test_step_and_tta_counts_compose():
    b, m = 4, SMALL
    fwd = counts.stil_forward_flops(b, m)
    assert counts.stil_step_flops(b, m) == (
        3 * fwd + counts.backbone_flops(b, m)
        + counts.heads_flops(b, m, teacher=True))
    assert counts.stats_pass_flops(b, m) == counts.image_tower_flops(
        b, m["img_size"])
    assert counts.tent_step_flops(b, m) == (
        counts.backbone_flops(b, m) + counts.image_tower_flops(b, 64))
    assert counts.score_flops(b, m) == fwd


def test_peaks_are_the_h100_data_sheet():
    assert counts.PEAK_BF16_FLOPS == 989e12
    assert counts.PEAK_HBM_BYTES_PER_S == 3.35e12
