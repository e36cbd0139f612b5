"""Configuration of the port.

The fields of ``grounded_video_description_tpu/config.py::GVDConfig``
that the port reads (greedy captioning, the supervised train step and
the evaluator), under the same names, with the same defaults and derived
widths (tests/test_torch_slice.py holds the two equal).  The port keeps
its own copy so that it runs where the JAX package is not installed.

Flags choose the hand-written kernels, as the JAX package's flags choose
its Pallas kernels.  At inference: ``use_pallas`` (K3, the per-token
region attention), ``use_pallas_rnn`` (K2, the BiRNN recurrence),
``use_pallas_encoder`` (K1, the obj_interact layer), ``use_pallas_mha``
(K7, the obj_interact self-attention when K1 is off) and
``use_pallas_decode`` (K6, the whole greedy decode; ``quantize_banks``
takes the step loop with int8 banks instead).  In training:
``attn_train_impl`` (K4, the obj_interact attention: "xla" plain
attention, "pallas" the kernel's forward and backward, "hybrid" the plain
forward and the kernel's backward).  ``pallas_encoder_grounding_guard``
turns K1 off in evaluations that score grounding
(``engine/evaluator.py::grounding_eval_cfg``).  A kernel runs only on
CUDA tensors; on CPU tensors the flag takes the plain version.  Unlike
the JAX package, which turns its kernels off away from the TPU, the port
honours every flag on every device.

The evaluator's fields (``language_eval``, ``eval_obj_grounding``,
``eval_obj_grounding_gt``, the reference files, ``val_split``, ``id``)
are the JAX package's too (``beam_size > 1`` decodes by beam search;
``vis_attn`` draws the attention over the frames under ``image_path``).
So are the training driver's (``main.py``: the dataset files, the epoch
loop, checkpointing, logging, ``profile_dir``), and of its device mesh
(``mesh_shape`` [D] or [D, M], ``coordinator_address``,
``num_processes``, ``process_id``).
``from_cli`` parses flags named after these fields, so a JAX flag the
port does not read is an argparse error.  The port's own captioner,
``att_model`` "lm" (``models/lm.py``), takes ``GVDLMConfig``: these
fields and ``lm``, its language model's block, which ``--lm`` reads from
a JSON file; ``GVDConfig`` itself stays field for field the JAX
package's.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GVDConfig:
    # ---- data input (opts.py:13-28) ----
    path_opt: Optional[str] = None
    input_json: str = ""
    input_dic: str = ""
    proposal_h5: str = ""
    feature_root: str = ""
    seg_feature_root: str = ""
    glove_file: str = ""
    packed_cache_dir: str = ""

    # ---- model dims (opts.py:38-64) ----
    rnn_size: int = 1024
    input_encoding_size: int = 512
    att_hid_size: int = 512
    fc_feat_size: int = 3072      # rgb_feat_size + motion_feat_size
    rgb_feat_size: int = 2048
    motion_feat_size: int = 1024
    att_feat_size: int = 2048
    t_attn_size: int = 480
    num_sampled_frm: int = 10
    num_prop_per_frm: int = 100
    prop_thresh: float = 0.2
    glove_dim: int = 300
    loc_encoding_size: int = 300
    seg_info_size: int = 50

    att_model: str = "topdown"          # topdown | transformer | lm
    att_input_mode: str = "both"        # both | featmap | region | dual_region
    t_attn_mode: str = "bigru"          # bilstm | bigru
    transfer_mode: str = "cls"          # none | cls | glove | both
    region_attn_mode: str = "mix"       # dp | add | cat | mix | mix_mul

    enable_BUTD: bool = False
    obj_interact: bool = False
    exclude_bgd_det: bool = False

    # ---- loss weights (opts.py:70-73) ----
    w_att2: float = 0.0
    w_grd: float = 0.0
    w_cls: float = 0.0
    disable_caption: bool = False

    # ---- optimization (opts.py:76-108) ----
    max_epochs: int = 40
    batch_size: int = 10
    grad_clip: float = 0.1
    drop_prob_lm: float = 0.5
    loc_drop: float = 0.5
    enc_drop: float = 0.2     # context-enc / obj_interact dropout
    seq_per_img: int = 1
    seq_length: int = 20
    optim: str = "adam"                 # sgd | adam | adamax
    learning_rate: float = 5e-4
    learning_rate_decay_start: int = 1
    learning_rate_decay_every: int = 3
    learning_rate_decay_rate: float = 0.8
    optim_alpha: float = 0.9
    optim_beta: float = 0.999
    optim_epsilon: float = 1e-8
    weight_decay: float = 0.0
    finetune_lr_scale: float = 0.1      # ctx2pool_grd / vis_embed group
    seed: int = 123

    beam_size: int = 1                  # > 1: beam search

    # ---- run, checkpointing and evaluation (opts.py:111-155) ----
    image_path: str = ""
    data_path: str = "data"
    start_from: Optional[str] = None
    id: str = ""
    train_split: str = "training"
    val_split: str = "validation"
    inference_only: bool = False
    densecap_references: List[str] = field(default_factory=lambda: [
        "./data/anet/anet_entities_val_1.json",
        "./data/anet/anet_entities_val_2.json",
    ])
    densecap_verbose: bool = False
    grd_reference: str = "tools/anet_entities/data/anet_entities_cleaned_class_thresh50_trainval.json"
    split_file: str = "tools/anet_entities/data/split_ids_anet_entities.json"
    eval_obj_grounding_gt: bool = False
    eval_obj_grounding: bool = False
    vis_attn: bool = False              # utils/visualize.py
    val_images_use: int = -1
    val_every_epoch: int = 2
    checkpoint_path: str = "save"
    language_eval: bool = False
    load_best_score: int = 1
    disp_interval: int = 100

    # ---- execution ----
    dtype: str = "float32"              # compute dtype: float32 | bfloat16
    use_pallas: bool = False            # K3
    use_pallas_rnn: bool = True         # K2
    use_pallas_mha: bool = False        # K7
    use_pallas_encoder: bool = True     # K1
    use_pallas_decode: bool = False     # K6
    use_pallas_encoder_train: bool = False   # K5; takes precedence over K4
    attn_train_impl: str = "xla"        # K4: xla | pallas | hybrid
    # int8 attention banks at greedy decode time (ops/quantize.py):
    # columns per abs-max scale group, 0 = one scale per row
    quantize_banks: bool = False
    quantize_group_size: int = 128
    # evaluations that score grounding run with K1 off
    # (engine/evaluator.py::grounding_eval_cfg)
    pallas_encoder_grounding_guard: bool = True
    # sequential microbatches per train batch; loss terms are
    # renormalized by the full batch's mask counts
    grad_accum: int = 1
    # logit head width rounded up to a multiple of this; pad columns are
    # masked before the log-softmax
    vocab_pad_to: int = 1
    # the device mesh: [D] or [D, 1] trains and evaluates data-parallel on
    # D processes, one per device; [D, M] adds a model axis of M ranks
    # that split the vocab head (parallel/tensor.py), D x M processes.
    # Multi-host: every host runs the driver with the coordinator's
    # host:port, the host count and its own index
    mesh_shape: Optional[List[int]] = None
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    log_jsonl: Optional[str] = None     # metrics JSONL sink
    tensorboard_dir: Optional[str] = None   # TensorBoard scalar mirror
    profile_dir: Optional[str] = None   # torch.profiler trace output

    # ---- from the dataset ----
    vocab_size: int = 0
    detect_size: int = 0
    unk_idx: int = -1       # -1 -> vocab_size - 1 (UNK appended last)
    max_gt_box: int = 100
    test_mode: bool = False

    @property
    def max_proposal(self) -> int:
        return self.num_sampled_frm * self.num_prop_per_frm

    @property
    def vocab_size_padded(self) -> int:
        m = max(self.vocab_pad_to, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def fc_feat_size_full(self) -> int:
        """fc feature + segment-info embedding (model.py:38-39)."""
        return self.fc_feat_size + self.seg_info_size

    @property
    def vis_encoding_size(self) -> int:
        """Visual-word embedding width per transfer mode (model.py:84-91)."""
        if self.transfer_mode in ("none", "cls"):
            return self.att_feat_size
        if self.transfer_mode == "both":
            return self.att_feat_size + self.glove_dim
        if self.transfer_mode == "glove":
            return self.glove_dim
        raise NotImplementedError(self.transfer_mode)

    @property
    def pool_feat_size(self) -> int:
        """Region-feature width fed to pool_embed (model.py:65-69)."""
        if self.enable_BUTD:
            return self.vis_encoding_size
        return (self.vis_encoding_size + self.loc_encoding_size
                + self.detect_size + 1)

    def validate(self) -> "GVDConfig":
        if self.enable_BUTD and self.att_input_mode != "region":
            raise ValueError("region attention only under the BUTD mode")
        if self.att_model not in ("topdown", "transformer", "lm"):
            raise ValueError(f"unknown att_model {self.att_model!r}")
        if (self.att_model == "lm") != (getattr(self, "lm", None)
                                        is not None):
            raise ValueError("att_model lm takes an lm block "
                             "(GVDLMConfig), and only it")
        if self.att_model == "lm":
            self._validate_lm()
        # two pairs the JAX package accepts and then mishandles: its
        # transformer greedy decode reads a quantized bank's shape, and its
        # beam search decodes with the untrained TopDown core
        if self.att_model == "transformer" and self.quantize_banks:
            raise ValueError("att_model transformer does not take "
                             "quantize_banks: its decoder cross-attends "
                             "the unquantized encodings")
        if self.att_model == "transformer" and self.beam_size > 1:
            raise ValueError("att_model transformer decodes greedily only "
                             "(beam_size 1): beam search runs the TopDown "
                             "core")
        if self.att_input_mode not in ("both", "featmap", "region",
                                       "dual_region"):
            raise ValueError(f"unknown att_input_mode {self.att_input_mode!r}")
        if self.region_attn_mode not in ("dp", "add", "cat", "mix",
                                         "mix_mul"):
            raise ValueError(
                f"unknown region_attn_mode {self.region_attn_mode!r}")
        if self.transfer_mode not in ("none", "cls", "glove", "both"):
            raise ValueError(f"unknown transfer_mode {self.transfer_mode!r}")
        if self.t_attn_mode not in ("bilstm", "bigru"):
            raise ValueError(f"unknown t_attn_mode {self.t_attn_mode!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.fc_feat_size != self.rgb_feat_size + self.motion_feat_size:
            raise ValueError(
                "fc_feat_size must equal rgb_feat_size + motion_feat_size")
        if self.attn_train_impl not in ("xla", "pallas", "hybrid"):
            raise ValueError(
                f"unknown attn_train_impl {self.attn_train_impl!r}")
        if self.optim not in ("adam", "sgd", "adamax"):
            raise ValueError(f"unknown optim {self.optim!r}")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by "
                f"grad_accum {self.grad_accum}")
        if self.mesh_shape is not None:
            shape = list(self.mesh_shape)
            if not 1 <= len(shape) <= 2 or min(shape) < 1:
                raise ValueError(f"mesh_shape {shape}: one or two sizes >= 1")
            if (self.batch_size // self.grad_accum) % shape[0]:
                raise ValueError(
                    f"microbatch {self.batch_size}//{self.grad_accum} must "
                    f"be divisible by the mesh data axis {shape[0]}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(f"process_id {self.process_id} is not one of "
                             f"{self.num_processes} processes")
        return self

    def _validate_lm(self) -> None:
        from grounded_video_description_torch.models.lm import LMShape
        shape = LMShape.of(self.lm)
        if self.vocab_size != shape.vocab:
            raise ValueError(f"att_model lm captions in the LM's vocabulary: "
                             f"vocab_size {self.vocab_size} != "
                             f"{shape.vocab}")
        if self.beam_size > 1:
            raise ValueError("att_model lm decodes greedily only "
                             "(beam_size 1)")
        if self.quantize_banks:
            raise ValueError("att_model lm does not take quantize_banks: "
                             "its projector reads the unquantized "
                             "encodings")
        if self.mesh_shape is not None and len(self.mesh_shape) > 1 \
                and self.mesh_shape[1] > 1:
            raise ValueError("att_model lm takes no model axis: its vocab "
                             "head is not split")

    def replace(self, **kw) -> "GVDConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "GVDConfig":
        """The fields of a YAML file (keys that are no field, and null
        values, are skipped), then ``overrides``."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known and v is not None}
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_cli(cls, argv: Optional[List[str]] = None) -> "GVDConfig":
        """Flags named after the fields (``--flag`` / ``--no-flag`` for a
        bool), overlaid on the YAML of ``--path_opt``: YAML values override
        the defaults, explicit flags override both, as in the JAX
        package's ``GVDConfig.from_cli``."""
        parser = argparse.ArgumentParser(
            prog="python -m grounded_video_description_torch.main")
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            if f.type in ("bool", bool):
                parser.add_argument(name,
                                    action=argparse.BooleanOptionalAction,
                                    default=None)
            elif f.name in ("densecap_references", "mesh_shape"):
                parser.add_argument(name, type=str, nargs="+", default=None)
            elif f.name == "lm":
                parser.add_argument(name, type=_lm_block, default=None,
                                    metavar="JSON",
                                    help="a JSON file: the LM block, or a "
                                         "configuration holding it as 'lm'")
            else:
                typ = {"int": int, "float": float}.get(f.type, str)
                parser.add_argument(name, type=typ, default=None)
        explicit = {k: v for k, v in vars(parser.parse_args(argv)).items()
                    if v is not None}
        if "mesh_shape" in explicit:
            explicit["mesh_shape"] = [int(x) for x in explicit["mesh_shape"]]
        path_opt = explicit.get("path_opt")
        cfg = cls.from_yaml(path_opt) if path_opt else cls()
        cfg = cfg.replace(**explicit)
        cfg = cfg.replace(test_mode=cfg.val_split in ("testing",
                                                      "hidden_test"))
        return cfg.validate()


@dataclass
class GVDLMConfig(GVDConfig):
    """The config of ``att_model`` "lm": ``GVDConfig``'s fields and the
    language model's block (``models/lm.py``: the published config.json
    keys of a DeepSeek-V3 LM, the projector's ``projector_hidden_size``,
    ``start_id`` and ``torch_dtype``)."""
    lm: Optional[Dict] = None


def _lm_block(path: str) -> Dict:
    """The LM block of ``--lm``'s JSON file: the file itself, or its
    ``lm`` key (a benchmark configuration file)."""
    import json

    with open(path) as f:
        raw = json.load(f)
    return raw.get("lm", raw)


def tiny_test_config(**overrides) -> GVDConfig:
    """The JAX package's ``tiny_test_config``, restricted to these fields."""
    base = dict(
        rnn_size=64,
        input_encoding_size=32,
        att_hid_size=32,
        fc_feat_size=48,
        rgb_feat_size=32,
        motion_feat_size=16,
        att_feat_size=24,
        t_attn_size=16,
        num_sampled_frm=4,
        num_prop_per_frm=5,
        glove_dim=12,
        loc_encoding_size=16,
        seg_info_size=8,
        seq_length=8,
        seq_per_img=1,
        batch_size=2,
        vocab_size=50,
        detect_size=10,
        max_gt_box=6,
        drop_prob_lm=0.0,
        loc_drop=0.0,
        enc_drop=0.0,
    )
    base.update(overrides)
    cls = GVDLMConfig if "lm" in overrides else GVDConfig
    return cls(**base).validate()
