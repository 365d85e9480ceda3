"""Architecture config system: a copy of ``repro/configs/base.py``.

Every assigned architecture is an ``ArchConfig`` instance; ``reduced()``
returns a CPU-smoke-test variant of the same family (<=2 layers,
d_model<=512, <=4 experts).  Pure Python, kept byte for byte in its
arithmetic so that ``param_count()`` and ``reduced()`` give the
reference's numbers (tests/test_torch_lm.py holds them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor used by the dense (einsum) dispatch path
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int            # N — per-head state size
    head_dim: int = 64        # P — channels per SSD head
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 128          # SSD chunk length
    conv_dim: int = 4         # depthwise conv width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    source: str = ""          # citation
    # attention variants
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    local_global_alternate: bool = False  # gemma2: even layers local
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    # mixture-of-experts
    moe: Optional[MoEConfig] = None
    # state-space
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): parallel attn + mamba heads, meta tokens
    hybrid_meta_tokens: int = 0
    hybrid_global_layers: Tuple[int, ...] = ()
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0          # fixed encoder memory length (stub frontend)
    # vlm
    vision_tokens: int = 0
    # block variants
    sandwich_norms: bool = False   # gemma2: post-attn/post-mlp norms
    mlp_act: str = "silu"          # glu activation (gemma2: gelu)
    scale_embed: bool = False      # gemma2: x *= sqrt(d_model)
    # numerics
    dtype: str = "bfloat16"   # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so embeddings shard on any mesh."""
        return _round_up(self.vocab, 256)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode available (SSM / hybrid / sliding-window)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
            or self.local_global_alternate
        )

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder backbone

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if not self.attention_free and self.family != "ssm":
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.moe is not None:
            per_layer += self.moe.num_experts * 3 * d * ff + d * self.moe.num_experts
        elif ff > 0:
            per_layer += 3 * d * ff  # swiglu/geglu
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            per_layer += d * (2 * di + 2 * nh * self.ssm.state_dim + nh) + di * d
        total = emb + L * per_layer
        if self.enc_layers:
            enc_per = 4 * d * self.n_heads * hd + 3 * d * ff
            total += self.enc_layers * enc_per + L * 2 * d * self.n_heads * hd  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        full = self.param_count()
        expert_all = L * self.moe.num_experts * 3 * d * ff
        expert_active = L * self.moe.top_k * 3 * d * ff
        return full - expert_all + expert_active

    def reduced(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw["moe"] = self.moe
        kw["ssm"] = self.ssm
        kw["arch_id"] = self.arch_id + "-reduced"
        kw["n_layers"] = min(self.n_layers, 2)
        kw["d_model"] = min(self.d_model, 256)
        kw["d_ff"] = min(self.d_ff, 512) if self.d_ff else 0
        kw["vocab"] = min(self.vocab, 512)
        if self.n_heads:
            # keep GQA ratio where possible
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            kw["n_heads"] = min(self.n_heads, 4)
            kw["n_kv_heads"] = max(1, kw["n_heads"] // min(ratio, kw["n_heads"]))
            kw["head_dim"] = kw["d_model"] // kw["n_heads"]
        if self.moe is not None:
            kw["moe"] = MoEConfig(num_experts=4, top_k=min(self.moe.top_k, 2),
                                  capacity_factor=self.moe.capacity_factor,
                                  aux_loss_coef=self.moe.aux_loss_coef)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=min(self.ssm.state_dim, 16),
                                  head_dim=32, expand=2, chunk=16,
                                  conv_dim=self.ssm.conv_dim)
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.hybrid_meta_tokens:
            kw["hybrid_meta_tokens"] = 4
        kw["hybrid_global_layers"] = tuple(
            i for i in self.hybrid_global_layers if i < kw["n_layers"]) or ((0,) if self.hybrid_global_layers else ())
        if self.enc_layers:
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.vision_tokens:
            kw["vision_tokens"] = 8
        kw["dtype"] = "float32"  # exactness on CPU
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
