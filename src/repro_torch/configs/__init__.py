"""Config registry: ``get_config("<arch-id>")`` and ``ARCH_IDS``.

The ten architectures of ``repro/configs/`` as data, one ``ArchConfig``
each with the reference's fields; ``get_config("<id>-reduced")`` gives
the CPU-sized variant of the same family.
"""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, MoEConfig,
                                      SSMConfig, ShapeConfig)

_CONFIGS = (
    # OLMoE-1B-7B [arXiv:2409.02060]
    ArchConfig(arch_id="olmoe-1b-7b", family="moe", n_layers=16,
               d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
               vocab=50304, head_dim=128, rope_theta=10000.0,
               moe=MoEConfig(num_experts=64, top_k=8),
               source="arXiv:2409.02060"),
    # Hymba-1.5B [arXiv:2411.13676]: parallel attention + mamba heads
    ArchConfig(arch_id="hymba-1.5b", family="hybrid", n_layers=32,
               d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
               vocab=32001, head_dim=64, sliding_window=1024,
               hybrid_meta_tokens=128, hybrid_global_layers=(0, 15, 31),
               ssm=SSMConfig(state_dim=16, head_dim=64, expand=2,
                             chunk=128),
               source="arXiv:2411.13676"),
    # Gemma2-9B [arXiv:2408.00118]
    ArchConfig(arch_id="gemma2-9b", family="dense", n_layers=42,
               d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
               vocab=256000, head_dim=256, sliding_window=4096,
               local_global_alternate=True, attn_logit_softcap=50.0,
               final_logit_softcap=30.0, tie_embeddings=True,
               sandwich_norms=True, mlp_act="gelu", scale_embed=True,
               source="arXiv:2408.00118"),
    # Whisper-large-v3 [arXiv:2212.04356]: 32 decoder + 32 encoder layers
    ArchConfig(arch_id="whisper-large-v3", family="audio", n_layers=32,
               enc_layers=32, enc_seq=1500, d_model=1280, n_heads=20,
               n_kv_heads=20, d_ff=5120, vocab=51866, head_dim=64,
               qkv_bias=True, source="arXiv:2212.04356"),
    # DBRX-132B [hf:databricks/dbrx-base]
    ArchConfig(arch_id="dbrx-132b", family="moe", n_layers=40,
               d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
               vocab=100352, head_dim=128, rope_theta=500000.0,
               moe=MoEConfig(num_experts=16, top_k=4),
               source="hf:databricks/dbrx-base"),
    # Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD
    ArchConfig(arch_id="mamba2-1.3b", family="ssm", n_layers=48,
               d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
               ssm=SSMConfig(state_dim=128, head_dim=64, expand=2,
                             chunk=128),
               source="arXiv:2405.21060"),
    # StableLM-12B [hf:stabilityai/stablelm-2-1_6b]
    ArchConfig(arch_id="stablelm-12b", family="dense", n_layers=40,
               d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
               vocab=100352, head_dim=160,
               source="hf:stabilityai/stablelm-2-1_6b"),
    # InternVL2-1B [arXiv:2404.16821]: the LM backbone + patch prefix
    ArchConfig(arch_id="internvl2-1b", family="vlm", n_layers=24,
               d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
               vocab=151655, head_dim=64, qkv_bias=True,
               vision_tokens=256, rope_theta=1000000.0,
               source="arXiv:2404.16821"),
    # Qwen2-72B [arXiv:2407.10671]
    ArchConfig(arch_id="qwen2-72b", family="dense", n_layers=80,
               d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
               vocab=152064, head_dim=128, qkv_bias=True,
               rope_theta=1000000.0, source="arXiv:2407.10671"),
    # TinyLlama-1.1B [arXiv:2401.02385]: llama2 architecture
    ArchConfig(arch_id="tinyllama-1.1b", family="dense", n_layers=22,
               d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
               vocab=32000, head_dim=64, source="arXiv:2401.02385"),
)

_REGISTRY = {c.arch_id: c for c in _CONFIGS}

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch_id: str) -> ArchConfig:
    if arch_id.endswith("-reduced"):
        return get_config(arch_id[: -len("-reduced")]).reduced()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _REGISTRY[arch_id]


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "INPUT_SHAPES",
    "ARCH_IDS", "get_config",
]
