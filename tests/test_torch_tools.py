"""PyTorch port, the tools of the bf16 bars at trained weights, on the CPU
at the tiny widths: ``tools/overfit.py`` trains 2 steps, saves, and a
second run resumes to step 4 with the weights, optimizer state and
dropout generator of an uninterrupted 4-step run; ``tools/kernel_delta.py``
on the CPU, where every kernel flag takes its plain version, holds every
variant at agreement 1.0 with its baseline; and both refuse to run on a
card that is not there."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import json
import os

import pytest
import torch

from grounded_video_description_torch import config as tconfig
from grounded_video_description_torch.engine.checkpoint import STATE_FILE
from grounded_video_description_torch.tools import kernel_delta, overfit

CPU = torch.device("cpu")


def _cfg(**kw):
    """overfit's flagship flags at the tiny widths: bf16 through K5,
    4 segments a batch in 2 microbatches."""
    flags = dict(obj_interact=True, dtype="bfloat16", batch_size=4,
                 grad_accum=2, w_att2=0.05, w_cls=0.1,
                 learning_rate_decay_start=-1, use_pallas_encoder_train=True,
                 drop_prob_lm=0.5)
    flags.update(kw)
    return tconfig.tiny_test_config(**flags)


def _blob(directory):
    return torch.load(os.path.join(directory, "model", STATE_FILE),
                      map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-step run straight through, and a 2-step run resumed to 4."""
    root = tmp_path_factory.mktemp("overfit")
    cfg = _cfg()
    lines = []
    straight = overfit.overfit(cfg, str(root / "straight"), steps=4, pool=2,
                               device=CPU, log=lines.append)
    first = overfit.overfit(cfg, str(root / "pieces"), steps=2, pool=2,
                            device=CPU, log=lines.append)
    resumed = overfit.overfit(cfg, str(root / "pieces"), steps=4, pool=2,
                              device=CPU, log=lines.append)
    return dict(cfg=cfg, root=root, lines=lines, straight=straight,
                first=first, resumed=resumed)


def test_overfit_runs_two_steps_and_resumes(trained):
    root = trained["root"]
    assert trained["first"]["step"] == 2
    assert trained["straight"]["step"] == trained["resumed"]["step"] == 4
    assert json.loads(trained["lines"][-2]) == {"resumed_at": 2}
    a, b = _blob(root / "straight"), _blob(root / "pieces")
    assert a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    for sa, sb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    # the LM loss logged at step 0 and at the last step, and saved
    with open(root / "pieces" / "infos.json") as f:
        infos = json.load(f)
    assert sorted(infos["lm_loss"], key=int) == ["0", "1", "3"]
    assert infos["lm_loss"] == trained["straight"]["lm_loss"] | {
        "1": infos["lm_loss"]["1"]}
    assert infos["pool"] == 2 and infos["config"]["dtype"] == "bfloat16"


def test_overfit_refuses_another_pool(trained):
    with pytest.raises(ValueError, match="pool"):
        overfit.overfit(trained["cfg"], str(trained["root"] / "pieces"),
                        steps=5, pool=3, device=CPU, log=lambda _: None)


def test_overfit_refuses_another_config(trained):
    """A checkpoint made under other flags (another tree's, or another
    run's) is not resumed, whatever step it reached."""
    with pytest.raises(ValueError, match="another config.*learning_rate"):
        overfit.overfit(trained["cfg"].replace(learning_rate=1e-3),
                        str(trained["root"] / "pieces"), steps=4, pool=2,
                        device=CPU, log=lambda _: None)


def test_kernel_delta_refuses_a_checkpoint_of_another_config(trained,
                                                             tmp_path):
    """kernel_delta measures the flagship config; the tiny checkpoint is
    refused before any weight is read."""
    with pytest.raises(ValueError, match="another config"):
        kernel_delta.main(["--ckpt", str(trained["root"] / "pieces"),
                           "--out", str(tmp_path / "r.json"),
                           "--device", "cpu"])
    assert not (tmp_path / "r.json").exists()


def test_kernel_delta_on_the_cpu_agrees_everywhere(trained, tmp_path):
    """On CPU tensors every kernel flag takes its plain version, so every
    variant decodes its baseline's tokens and attention argmaxes and
    scores its grounding; the floors are shares."""
    state = _blob(trained["root"] / "straight")["model"]
    report = kernel_delta.measure(trained["cfg"], state, pool=2, device=CPU,
                                  work_dir=str(tmp_path))
    assert len(report["batches"]) == 3 and report["batch_size"] == 4
    assert "fresh" in report["batches"][2]
    assert set(report["variants"]) == set(kernel_delta.VARIANTS)
    for name, r in report["variants"].items():
        assert len(r["per_batch"]) == 3, name
        for row in r["per_batch"]:
            assert row["token"] == row["exact_sentence"] == 1.0, name
            assert row["attn_argmax"] == 1.0, name
            for k in kernel_delta.BOX_KEYS:
                assert row[f"{k}_delta"] == 0.0, (name, k)
                assert 0.0 <= row[k] <= 1.0, (name, k)
        assert r["token_mean"] == r["token_min"] == 1.0, name
    assert r["against"] == "bf16_plain_beam3"
    assert report["variants_vs_f32"]["bf16_defaults_beam3"]["against"] == (
        "f32_plain_beam3")
    for name, r in [*report["variants_vs_f32"].items(),
                    *report["floors"].items()]:
        assert 0.0 <= r["token_min"] <= r["token_mean"] <= 1.0, name


@pytest.mark.parametrize("tool", [overfit, kernel_delta])
def test_tools_refuse_a_missing_card(tool, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    args = (["--out", str(tmp_path)] if tool is overfit else
            ["--ckpt", str(tmp_path), "--out", str(tmp_path / "r.json")])
    assert tool.main(args) == 1
    assert "no CUDA device" in capsys.readouterr().err
