"""Architecture configuration: a copy of the JAX package's ``ArchConfig``.

One dataclass covers all 10 assigned architectures; the per-arch modules
of this package instantiate the exact configs (with source citations) and
register them under their id for ``--arch <id>`` selection
(``configs.archs.ALL_ARCHS`` lists them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # block flavour
    block_type: str = "attention"  # attention | rwkv6 | mamba2
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rms"              # rms | layer
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # e.g. Mixtral SWA 4096
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 64
    ssm_expand: int = 2
    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    # hybrid (zamba2): a weight-shared attention block every k ssm blocks
    shared_attn_period: int = 0
    # modality frontend (stubbed per spec: embeddings arrive precomputed)
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 0       # vision: image patches prepended
    n_codebooks: int = 0           # audio: EnCodec codebooks
    # long-context policy for the 500k decode shape
    long_context: str = "skip"     # native | swa_variant | skip
    source: str = ""
    # training-graph knobs
    scan_layers: bool = True
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/flavour, tiny everything."""
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        # keep the GQA ratio flavour: MQA stays MQA
        if self.n_kv_heads == 1:
            n_kv = 1
        head_dim = (d_model // n_heads) if n_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 if self.shared_attn_period == 0 else max(
                2, self.shared_attn_period),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_head_dim=(2 * d_model // max(1, min(self.ssm_heads, 4))
                          if self.ssm_heads else self.ssm_head_dim),
            rwkv_head_dim=32 if self.block_type == "rwkv6" else
            self.rwkv_head_dim,
            rwkv_lora_decay=16, rwkv_lora_mix=8,
            ssm_chunk=16,
            sliding_window=(64 if self.sliding_window else None),
            frontend_tokens=min(self.frontend_tokens, 16),
            scan_layers=False,
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Dict[str, ArchConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    # import per-arch modules for registration side effects
    from repro_torch.configs import archs  # noqa: F401
