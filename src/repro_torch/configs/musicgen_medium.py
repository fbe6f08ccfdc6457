"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284].

48L, d_model 1536, 24 heads (full MHA), d_ff 6144, vocab 2048 per codebook,
4 codebooks (embeddings summed; one LM head per codebook). The EnCodec
conv codec itself is the stubbed audio frontend, as in the JAX package: the
batch carries precomputed codebook token frames.  Plain GELU MLP +
LayerNorm as in the original (standard transformer decoder).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64, mlp="gelu", norm="layer",
    frontend="audio", n_codebooks=4, long_context="swa_variant",
    source="arXiv:2306.05284 (MusicGen)",
))
