"""Whole runs of the cells on the CPU at small sizes, with the look for a
chip skipped: the result line's keys, ``correct`` on a sound run, and
``correct`` false with the program broken underneath (a served word
altered where it is produced; a train step that leaves the state
unchanged, or that takes half of the batch) and with the control, the
plain reference with its products in TF32 in the program's place."""

import json

import pytest
import torch
from conftest import MID, small_cell

from benchmark import harness

SERVE = ("topdown-greedy", "transformer-greedy", "topdown-beam3")
CELLS = SERVE + ("topdown-train",)


def _cell(name, **kw):
    """A small cell; the train cell at 16 rows in 4 microbatches."""
    cell = small_cell(name, **kw)
    if name == "topdown-train":
        cell.traffic.update(batch_size=kw.get("batch", 16), grad_accum=4)
    return cell


def _driver(cell):
    return harness.load_module(harness.BENCH_DIR / "drivers" /
                               f"{cell.traffic['driver']}.py")


KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    cell = _cell(name, seed=2**31 + 3)
    result = harness.run_cell(cell, look=False)
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert json.loads(json.dumps(result)) == result


# the end word's bias raised so far that at seed 8 some captions end early
END_BIAS = {"topdown-greedy": 0.3, "transformer-greedy": 0.6,
            "topdown-beam3": 0.15}


@pytest.mark.parametrize("name", SERVE)
def test_captions_that_end_early_are_judged(name, monkeypatch, capsys):
    """With the end word's output bias raised, some served captions end
    before the last step (a beam caption's region indices are -1 after
    its end); the run is judged and correct."""
    import benchmark.weights as weights
    draw = weights.draw_weights

    def ending(config, seed, device):
        w = draw(config, seed, device)
        V = config["model"]["vocab_size"]
        for k in [k for k, t in w.items()
                  if k.endswith("bias") and tuple(t.shape) == (V,)]:
            w[k] = w[k].clone()
            w[k][0] += END_BIAS[name]
        return w
    monkeypatch.setattr(weights, "draw_weights", ending)
    result = harness.run_cell(small_cell(name, seed=8, batch=4), look=False)
    words, of = map(int, capsys.readouterr().err.split(": ")[-1]
                    .split(" served")[0].split(" of "))
    assert 0 < words < of
    assert result["correct"] is True


def _alter(seq):
    """The served word at (0, 2) changed to the next word."""
    seq = seq.clone()
    seq[0, 2] = (seq[0, 2] + 1) % 49 + 1
    return seq


def test_an_altered_greedy_word_is_caught(monkeypatch):
    from grounded_video_description_torch.models import gvd
    plain = gvd.greedy_decode_fused

    def broken(model, enc, pnt_mask):
        seq, lp, att2 = plain(model, enc, pnt_mask)
        return _alter(seq), lp, att2
    monkeypatch.setattr(gvd, "greedy_decode_fused", broken)
    result = harness.run_cell(small_cell("topdown-greedy"), look=False)
    assert result["correct"] is False
    assert result["check"]["logit_gap"]["value"] > \
        result["check"]["logit_gap"]["limit"]


def test_an_altered_transformer_word_is_caught(monkeypatch):
    from grounded_video_description_torch.models import gvd
    plain = gvd.xf.decoder_greedy

    def broken(*args, **kw):
        return _alter(plain(*args, **kw))
    monkeypatch.setattr(gvd.xf, "decoder_greedy", broken)
    result = harness.run_cell(small_cell("transformer-greedy"), look=False)
    assert result["correct"] is False


def test_an_altered_beam_word_is_caught(monkeypatch):
    from grounded_video_description_torch.models import gvd
    plain = gvd.beam_search

    def broken(model, enc, beam_size):
        seq, lp, ind, frm = plain(model, enc, beam_size=beam_size)
        return _alter(seq), lp, ind, frm
    monkeypatch.setattr(gvd, "beam_search", broken)
    result = harness.run_cell(small_cell("topdown-beam3"), look=False)
    assert result["correct"] is False


def test_a_train_step_that_changes_nothing_is_caught(monkeypatch):
    from grounded_video_description_torch.engine.trainer import Trainer
    monkeypatch.setattr(Trainer, "train_step", _unchanged(Trainer.train_step))
    result = harness.run_cell(_cell("topdown-train"), look=False)
    assert result["correct"] is False
    assert result["check"]["step_err"]["value"] == pytest.approx(1.0)


def _unchanged(step):
    def broken(self, batch, lr):
        before = [p.detach().clone() for p in self.params]
        out = step(self, batch, lr)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(b)
        return out
    return broken


def test_a_train_step_on_half_the_batch_is_caught(monkeypatch):
    from grounded_video_description_torch.engine.trainer import Trainer
    step = Trainer.train_step

    def broken(self, batch, lr):
        n, accum = batch["seg_feat"].shape[0], self.cfg.grad_accum
        rows = torch.cat([torch.arange(i * n // accum,
                                       i * n // accum + n // accum // 2)
                          for i in range(accum)])
        return step(self, {k: v[rows] for k, v in batch.items()}, lr)
    monkeypatch.setattr(Trainer, "train_step", broken)
    result = harness.run_cell(_cell("topdown-train"), look=False)
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name):
    """At MID sizes on two seeds: the control fails one of the cell's
    numbers under the cell's limits; the program passes all."""
    for seed in (1, 2):
        cell = _cell(name, seed=seed, sizes=MID, batch=8)
        got = _driver(cell).readings(cell)
        limits = {k: v["limit"] for k, v in cell.checks["numbers"].items()}
        assert all(got["program"][k] <= limits[k] for k in limits), got
        assert any(got["control"][k] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct_on_the_card(name, cuda):
    """The same on the card, at MID's widths with 500 proposals and 240
    frames."""
    cell = _cell(name, seed=5, sizes=dict(MID, num_prop_per_frm=100,
                                          t_attn_size=240), batch=16)
    cell.device = "cuda"
    got = _driver(cell).readings(cell)
    limits = {k: v["limit"] for k, v in cell.checks["numbers"].items()}
    assert all(got["program"][k] <= limits[k] for k in limits), got
    assert any(got["control"][k] > limits[k] for k in limits), got
