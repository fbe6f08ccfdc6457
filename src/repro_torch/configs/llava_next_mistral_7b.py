"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Language backbone: 32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128),
d_ff 14336, vocab 32000.  The anyres-tiled SigLIP/CLIP vision tower +
projector are the stubbed vision frontend, as in the JAX package: the
batch carries ``image_embeds`` (B, frontend_tokens, d_model) already
projected, which the decoder consumes as a prefix.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, mlp="swiglu", norm="rms",
    frontend="vision", frontend_tokens=1152, long_context="swa_variant",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
