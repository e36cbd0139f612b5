"""Helpers of the benchmark's CPU tests: small configurations of the
cells, run on the CPU (the program's kernel wrappers take their plain
versions on CPU tensors)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the configurations' shapes at a size a test run holds
TINY = dict(vocab_size=50, detect_size=10, rnn_size=64,
            input_encoding_size=32, att_hid_size=32, fc_feat_size=48,
            rgb_feat_size=32, motion_feat_size=16, att_feat_size=24,
            t_attn_size=16, num_sampled_frm=4, num_prop_per_frm=5,
            loc_encoding_size=16, seg_info_size=8, seq_length=8,
            max_gt_box=6)
MID = dict(vocab_size=500, detect_size=40, rnn_size=256,
           input_encoding_size=128, att_hid_size=128, fc_feat_size=384,
           rgb_feat_size=256, motion_feat_size=128, att_feat_size=256,
           t_attn_size=48, num_sampled_frm=5, num_prop_per_frm=20,
           loc_encoding_size=64, seg_info_size=16, seq_length=20,
           max_gt_box=10)


def small_cell(name: str, seed: int = 7, sizes=TINY, batch: int = 3,
               seconds: float = 0.3):
    """The manifest's cell ``name`` at ``sizes`` and batch ``batch``, on
    the CPU."""
    from benchmark import harness
    cell = harness.load_cell(name, seed, seconds, False)
    cell.device = "cpu"
    cell.started = time.perf_counter()
    cell.config["model"].update(sizes)
    cell.traffic["batch_size"] = batch
    return cell


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
