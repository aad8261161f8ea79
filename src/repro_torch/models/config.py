"""Architecture configuration shared by every model family.

Counterpart of ``repro/models/config.py`` (pure Python, copied so the port
imports nothing of the JAX package).  One ``ArchConfig`` fully describes an
architecture; the files in ``repro_torch/configs/`` instantiate the
published configs.  ``reduced()`` derives the tiny same-family variant the
CPU tests run.  ``SHAPES`` is the reference's grid of input shapes, which
the dry-run (``launch/dryrun.py``) crosses with every arch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu (SwiGLU) | gelu (fc1/fc2)
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    max_position_embeddings: int = 1 << 20

    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared_dff: int = 0         # width of the always-on shared expert MLP
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2-style shared attention block) ---
    hybrid_attn_every: int = 0      # apply the shared attn block every k SSM layers

    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0

    # --- modality frontends ---
    frontend: str = "none"          # none | audio_stub | vision_stub
    vlm_prefix: int = 0             # patch-embedding prefix length (llava)

    # whether the arch has a sub-quadratic path for long_500k decode
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)

    # ---- derived quantities ---------------------------------------------
    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        D, F, V, H = self.d_model, self.d_ff, self.vocab, self.n_heads
        hd, kvh = self.head_dim, self.n_kv_heads
        emb = V * D if self.tie_embeddings else 2 * V * D
        attn = D * H * hd + 2 * D * kvh * hd + H * hd * D   # q, kv, o
        if self.act == "silu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        n = emb
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            # in_proj: [z, x, B, C, dt]; out_proj
            ssm_layer = D * (2 * di + 2 * ns + nh) + di * D \
                + self.ssm_conv * (di + 2 * ns) + 3 * nh + di + D
            n += self.n_layers * ssm_layer
            if self.family == "hybrid" and self.hybrid_attn_every:
                n += attn + 3 * D * F + 2 * D   # one shared block
        elif self.enc_dec:
            per_enc = attn + mlp + 4 * D
            per_dec = 2 * attn + mlp + 6 * D
            n += self.n_enc_layers * per_enc + self.n_layers * per_dec
        else:
            per = attn + 2 * D
            if self.moe_experts:
                per += D * self.moe_experts              # router
                per += self.moe_experts * 3 * D * F      # expert FFNs
                if self.moe_shared_dff:
                    per += 3 * D * self.moe_shared_dff
            else:
                per += mlp
            n += self.n_layers * per
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.moe_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_extra = (self.moe_experts - self.moe_topk) * 3 * D * F
        return int(self.param_count() - self.n_layers * dense_extra)

    # ---- smoke-test reduction -------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=256,
            vocab=512,
            head_dim=32,
            sliding_window=None if self.sliding_window is None else 64,
            max_position_embeddings=4096,
        )
        if self.moe_experts:
            changes.update(moe_experts=4, moe_topk=2,
                           moe_shared_dff=128 if self.moe_shared_dff else 0)
        if self.family in ("ssm", "hybrid"):
            changes.update(ssm_state=16, ssm_headdim=32, ssm_chunk=16,
                           n_layers=4 if self.family == "hybrid" else 2)
        if self.family == "hybrid":
            changes.update(hybrid_attn_every=2)
        if self.enc_dec:
            changes.update(n_enc_layers=2)
        if self.vlm_prefix:
            changes.update(vlm_prefix=8)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)


#: shape grid assigned to the LM family (brief): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Skip rules recorded in DESIGN.md §4."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token decode has no "
                       "sub-quadratic path (DESIGN.md §4)")
    return True, ""
