"""Model layers of the port: the JAX package's ``models/layers.py`` in torch.

Conventions, as there:
  * params are plain mappings of tensors (the model keeps them as
    parameters in float32 and hands the layers matrices already cast to the
    activation dtype, norms in float32);
  * apply functions take any batch and sequence length;
  * attention supports MHA / GQA / MQA via n_kv_heads and causal and
    sliding-window masks, on the full sequence and on a KV cache;
  * softmax and norms accumulate in float32.

The attention core goes through the port's three Hopper kernels: full
sequences and prefill into a fresh cache through ``flash_mha`` (which also
covers the JAX package's query-chunked branch for long sequences), one token
over the cache through ``decode_mha`` (also over a sliding window's ring
buffer), and a segment that continues a cache (into a non-empty cache, a
wrapped ring, or longer than the ring) through ``cache_mha``, over every
slot masked by the position it holds.  Caches are updated in place.

On a mesh (the parameters and the batch are DTensors, inside
``utils.pjit_utils.activation_sharding``) the attention of every family
that has it (dense, MoE, vlm, audio, zamba2's shared block) pins its
activations where the JAX package does and runs on each rank's local shards
(``_mesh_attention``): flash over the rank's heads in training and
prefill, each rank's slice of a sequence-sharded cache in decode and in a
segment that continues a cache (a window's ring too), merged by the
slices' log-sum-exps; the cache is never gathered.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.cache_attention import cache_mha
from repro_torch.kernels.decode_attention import decode_mha, merge_weights
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.utils import pjit_utils as pj
from repro_torch.utils.pjit_utils import BATCH, constrain

Params = Mapping[str, torch.Tensor]

# ---------------------------------------------------------------------------
# initializers (normal(0, scale) from an explicit generator)
# ---------------------------------------------------------------------------

class Unfilled:
    """Stands in for the inits' ``torch.Generator``: ``normal_init`` then
    allocates on ``device`` and draws nothing (a tree a load overwrites)."""

    def __init__(self, device: torch.device):
        self.device = device


def normal_init(gen, shape, scale: float = 0.02) -> torch.Tensor:
    """normal(0, scale) of ``shape`` on the generator's device; left
    uninitialised where ``gen`` is ``Unfilled``."""
    if isinstance(gen, Unfilled):
        return torch.empty(shape, device=gen.device)
    return scale * torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: float = 0.02) -> torch.Tensor:
    return normal_init(gen, (in_dim, out_dim), scale)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               scale: float = 0.02) -> torch.Tensor:
    return normal_init(gen, (vocab, dim), scale)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; for the experts' (G, E, C, K) by (E, K, N) one ``bmm``
    with E its batch dim over (E, G * C, K), as the JAX package's einsums
    contract (``gecd,edf->gecf``): ``@`` would broadcast the stack over G
    and copy it G times, and its gradient too, and on a mesh DTensor
    expands the replicated stack to the global G on every rank (PERF.md
    §6: mixtral-8x7b's 224 GiB at 256 groups)."""
    if w.dim() != 3:
        return x @ w
    g, e, c, k = x.shape
    out = torch.bmm(x.transpose(0, 1).reshape(e, g * c, k), w)
    return out.view(e, g, c, w.shape[-1]).transpose(0, 1)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``w`` a matrix, or a stack of them: the experts', through
    ``_product``).  On a mesh in bf16 with ``w``'s input dim (its
    next-to-last) split over a mesh dim that does not split ``x``'s rows
    (tensor parallelism: each rank's product a part of the sum; where the
    rows are split there too, FSDP gathers ``w`` instead), the parts are
    formed and added in f32 and the sum rounded to bf16 once, as the
    one-device bf16 product
    accumulates in f32 and rounds once: parts rounded to bf16 before the
    sum would each add a rounding, which granite-3-2b's 40 layers carry
    past the serving contract's bf16 limit (PERF.md §6).  On a mesh
    the FSDP gather is made here, before any product: left to itself
    DTensor may keep ``w`` split where ``x``'s rows are and move ``x``
    instead (it weighs the bytes), and the backward then hands ``x`` a
    gradient laid out as no activation is, which the card's torch cannot
    redistribute (PERF.md §6)."""
    if not pj.on_mesh(w):
        return _product(x, w)
    from torch.distributed.tensor import Replicate
    w = w.redistribute(w.device_mesh, [
        Replicate() if q.is_shard(0) else p
        for p, q in zip(w.placements, x.placements)])
    if not (x.dtype == torch.bfloat16
            and any(p.is_shard(w.dim() - 2) for p in w.placements)):
        return _product(x, w)
    out = _product(x.float(), w.float())
    out = out.redistribute(out.device_mesh, [
        Replicate() if p.is_partial() else p for p in out.placements])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, device=None) -> Dict[str, torch.Tensor]:
    if kind == "rms":
        return {"scale": torch.ones(d, device=device)}
    if kind == "layer":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(params: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    elif kind == "layer":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (D/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ArchConfig
                   ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d,
                         scale=0.02 / max(1, cfg.n_layers) ** 0.5),
    }


def attention_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor,
                    window: Optional[int] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence (cache=None) or cached (prefill/decode) attention.

    positions: (B, S) absolute token positions for RoPE.  cache: {"k":
    (B, T, Hkv, D), "v": ..., "pos": (B, T)}, written in place and
    returned; cache_pos: (B,) write offset of the first new token.  T is
    the full max length, or with a window the ring's min(window, max_len)
    slots.  The cache is written as the JAX package writes it
    (``_segment_tokens``) and read through one of three kernels.  S == T
    (the segment fills the cache) and a segment into a fresh cache (every
    cache_pos 0) attend over the new tokens alone (flash).  One token
    (decode): without a window it writes slot cache_pos and reads slots <
    cache_pos + 1; with one it writes slot cache_pos % T of the ring and
    reads its min(cache_pos + 1, T) written slots.  A ring holds only
    positions in (p - T, p], all inside the window, so that is exactly the
    set the JAX package's position mask keeps.  Any other segment (into a
    non-empty cache, into a wrapped ring, or longer than the ring) reads
    every slot through ``cache_mha`` under the JAX package's position mask
    (written, causal, inside the window).  S > T without a window raises
    ``ValueError``, where the JAX package fails to trace.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    dt = x.dtype
    q, k, v = (matmul(x, params[w].to(dt)) for w in ("wq", "wk", "wv"))
    if pj.on_mesh(x):
        # rows whole before the heads' view: DTensor may split H * hd in
        # a way H does not divide
        q, k, v = (constrain(t, BATCH, None, None) for t in (q, k, v))
    q = q.view(b, s, cfg.n_heads, hd)
    k = k.view(b, s, cfg.n_kv_heads, hd)
    v = v.view(b, s, cfg.n_kv_heads, hd)
    if pj.on_mesh(x):
        out = _mesh_attention(q, k, v, positions, cfg, window, cache,
                              cache_pos)
        out = pj.pin_grad(out.reshape(b, s, cfg.n_heads * hd))
        return matmul(out, params["wo"].to(dt)), cache
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        # in training flash_mha keeps q, k and v alone for its backward:
        # what the JAX package's checkpoint of its query chunks keeps, so
        # nothing is added here (its backward's plain recompute holds one
        # layer's (B, H, S, S) scores at a time, JAX's one chunk's)
        out = flash_mha(q, k, v, causal=True, window=window)
    else:
        t = cache["k"].shape[1]
        # (a decode step never reads cache_pos on the host)
        if s == t or (1 < s < t and bool((cache_pos == 0).all())):
            # positions are consecutive, so the causal (and window) mask over
            # the new tokens is the kernel's index mask; the slots not
            # written here hold pos -1 and are masked in the JAX package
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            cache["pos"][:, :s] = positions
            out = flash_mha(q, k, v, causal=True, window=window)
        elif s == 1 and (window is None or t <= window):
            rows = torch.arange(b, device=x.device)
            slot = cache_pos.long()
            if window is not None:
                slot = slot % t
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][rows, slot] = positions[:, 0].to(torch.int32)
            lengths = (cache_pos + 1 if window is None
                       else torch.clamp(cache_pos + 1, max=t))
            out = decode_mha(q, cache["k"].to(dt), cache["v"].to(dt),
                             lengths)
        else:
            _write_segment(cache["k"], cache["v"], cache["pos"], k, v,
                           positions, cache_pos, t, 0, window)
            out = cache_mha(q, cache["k"].to(dt), cache["v"].to(dt),
                            positions, cache["pos"], window)

    out = out.reshape(b, s, cfg.n_heads * hd)
    return out @ params["wo"].to(dt), cache


def _segment_tokens(cache_pos: torch.Tensor, s: int, t: int, lo: int,
                    n: int, window: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the JAX package writes a segment of ``s`` tokens at
    ``cache_pos`` (B,) into a cache of ``t`` slots, read from slots lo ..
    lo + n - 1: (token (B, n), hit (B, n)), the token each slot gets and
    whether it gets one.  Without a window the segment goes to slots
    start + i, ``dynamic_update_slice``'s start clamped to [0, t - s] (a
    segment that would overflow the cache overwrites its last s slots);
    s > t raises ``ValueError`` (the JAX package fails to trace).  With
    one token i goes to the ring's slot (cache_pos + i) % t, and of the
    tokens that share a slot the later one stays (the JAX package's
    scatter on the CPU), so only the last t are written.  Shapes depend on
    shapes only (the dry-run's FakeTensors run it)."""
    if window is None and s > t:
        raise ValueError(f"a segment of {s} tokens does not fit a cache of "
                         f"{t} slots without a window")
    g = lo + torch.arange(n, device=cache_pos.device)[None]
    if window is None:
        i = g - cache_pos.long().clamp(0, t - s)[:, None]
    else:
        first = max(0, s - t)
        i = first + (g - cache_pos.long()[:, None] - first) % t
    return i.clamp(0, s - 1), (i >= 0) & (i < s)


@torch.no_grad()
def _write_segment(ck, cv, cp, k, v, positions, cache_pos, t: int, lo: int,
                   window: Optional[int]) -> None:
    """A segment's k, v and positions into slots lo .. lo + n - 1 of a
    cache of ``t`` slots (the tensors ck, cv, cp: the whole cache, lo 0, or
    a rank's T-slice of it), in place, where ``_segment_tokens`` puts
    them."""
    i, hit = _segment_tokens(cache_pos, k.shape[1], t, lo, ck.shape[1],
                             window)
    b = torch.arange(ck.shape[0], device=ck.device)[:, None]
    for buf, new in ((ck, k), (cv, v), (cp, positions)):
        keep = hit.view(*hit.shape, *([1] * (buf.dim() - 2)))
        buf.copy_(torch.where(keep, new[b, i].to(buf.dtype), buf))


# ---------------------------------------------------------------------------
# attention on a mesh
# ---------------------------------------------------------------------------

def _rows(x):
    """``x``'s placements with every split but the batch dim's undone."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def _rope_local(q, k, positions, theta: float):
    """RoPE on each rank's rows and heads (the tables are the rank's own,
    from its positions); one call a tensor, so that each one's gradient
    keeps its own layout."""
    def rope(x):
        return pj.local(lambda xl, pl: apply_rope(xl, pl, theta),
                        x.placements, x, positions)
    return rope(q), rope(k)


def _kv_heads(first: int, n_q: int, group: int):
    """The kv heads that query heads first .. first + n_q - 1 read (GQA:
    head h reads h // group): a range, each read by n_q / len of them in
    turn, where the kernel's mapping holds; else one per query head."""
    idx = [(first + j) // group for j in range(n_q)]
    uniq = sorted(set(idx))
    if idx == [u for u in uniq for _ in range(n_q // len(uniq))]:
        return uniq
    return idx


def _flash_local(q, k, v, window):
    """Flash attention on each rank's heads: q's heads split over ``model``
    where they divide (``constrain``), k and v split alike where theirs do,
    else whole on each rank and cut to the heads its query heads read."""
    from torch.distributed.tensor import Shard
    r, n = pj.shard_index(q, 2)
    h_loc = q.shape[2] // n
    group = q.shape[2] // k.shape[2]
    kv_split = any(isinstance(p, Shard) and p.dim == 2
                   for p in k.placements)
    heads = None if kv_split or n == 1 else _kv_heads(r * h_loc, h_loc,
                                                      group)

    def core(ql, kl, vl):
        if heads is not None:
            idx = torch.tensor(heads, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return flash_mha(ql, kl, vl, causal=True, window=window)

    return pj.local(core, q.placements, q, k, v)


def _write_prefill(cache, k, v, positions) -> None:
    """Each rank writes its own T-slice of a segment that starts at slot 0
    into its shard of the cache (rows as the cache splits them)."""
    r, _ = pj.shard_index(cache["k"], 1)
    rows = _rows(cache["k"])
    mesh = cache["k"].device_mesh
    k, v = k.redistribute(mesh, rows), v.redistribute(mesh, rows)
    positions = positions.redistribute(mesh, rows)
    s = k.shape[1]

    @torch.no_grad()
    def write(ck, cv, cp, kl, vl, pl):
        t = ck.shape[1]
        lo = r * t
        n = max(0, min(s - lo, t))
        if n:
            ck[:, :n] = kl[:, lo:lo + n]
            cv[:, :n] = vl[:, lo:lo + n]
            cp[:, :n] = pl[:, lo:lo + n]

    pj.local(write, None, cache["k"], cache["v"], cache["pos"], k, v,
             positions)


def _write_decode(cache, k, v, positions, slot) -> None:
    """The new token's k, v and position into slot ``slot`` of each row,
    on the one rank whose T-slice holds it (the others rewrite what they
    hold)."""
    r, _ = pj.shard_index(cache["k"], 1)
    rows = _rows(cache["k"])
    mesh = cache["k"].device_mesh
    k = k.redistribute(mesh, rows)
    v = v.redistribute(mesh, rows)
    positions = positions.redistribute(mesh, rows)
    slot = slot.redistribute(mesh, rows)

    @torch.no_grad()
    def write(ck, cv, cp, kl, vl, pl, sl):
        t = ck.shape[1]
        rel = sl.long() - r * t
        hit = (rel >= 0) & (rel < t)
        rel = rel.clamp(0, t - 1)
        b = torch.arange(ck.shape[0], device=ck.device)
        for buf, new in ((ck, kl[:, 0]), (cv, vl[:, 0]), (cp, pl[:, 0])):
            old = buf[b, rel]
            keep = hit.view(-1, *([1] * (old.dim() - 1)))
            buf[b, rel] = torch.where(keep, new.to(buf.dtype), old)

    pj.local(write, None, cache["k"], cache["v"], cache["pos"], k, v,
             positions, slot)


def _write_segment_sharded(cache, k, v, positions, cache_pos,
                           window: Optional[int]) -> None:
    """``_write_segment`` on a cache sequence-sharded on ``model``: each
    rank writes into its own T-slice the segment's tokens whose slots fall
    there."""
    r, _ = pj.shard_index(cache["k"], 1)
    rows = _rows(cache["k"])
    mesh = cache["k"].device_mesh
    t_all = cache["k"].shape[1]
    k, v, positions, cache_pos = (x.redistribute(mesh, rows)
                                  for x in (k, v, positions, cache_pos))

    def write(ck, cv, cp, kl, vl, pl, sl):
        _write_segment(ck, cv, cp, kl, vl, pl, sl, t_all, r * ck.shape[1],
                       window)

    pj.local(write, None, cache["k"], cache["v"], cache["pos"], k, v,
             positions, cache_pos)


def _read_sharded(read, cached, rows_args):
    """Attention over a cache sequence-sharded on ``model``: each rank runs
    ``read(first_slot, with_lse, *cached, *rows_args)`` on its own
    T-slice (the local shards of ``cached``, whose first is the k cache)
    and its rows of ``rows_args`` (each whole on the rank's rows), which
    returns the output (B, S, H, D), with ``with_lse`` and its log-sum-exp
    (B, S, H) too; the ranks' log-sum-exps are all-gathered, each output
    weighted by ``merge_weights`` (a rank with no live slot adds exactly
    nothing; a row no rank has one for gets the mean over all slots, as
    on one device) and the sum all-reduced.  The cache is never
    gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    k_c = cached[0]
    r, n = pj.shard_index(k_c, 1)
    mesh = k_c.device_mesh
    rows = _rows(k_c)
    rows_args = [x.redistribute(mesh, rows) for x in rows_args]

    def mine(*a):
        return read(r * a[0].shape[1], n > 1, *a)

    if n == 1:
        return pj.local(mine, rows, *cached, *rows_args)
    t_dims = {i for i, p in enumerate(k_c.placements)
              if isinstance(p, Shard) and p.dim == 1}
    stacked = tuple(Shard(0) if i in t_dims else
                    (Shard(p.dim + 1) if isinstance(p, Shard) else p)
                    for i, p in enumerate(rows))
    out, lse = pj.local(lambda *a: tuple(t[None] for t in mine(*a)),
                        (stacked, stacked), *cached, *rows_args)
    gathered = tuple(Replicate() if i in t_dims else p
                     for i, p in enumerate(stacked))
    lse = lse.redistribute(mesh, gathered)
    summed = tuple(Partial() if i in t_dims else p
                   for i, p in enumerate(rows))

    def weigh(ol, ll):
        # the ranks' T-slices are equal: the cache is split on T only
        # where n divides it (``launch.sharding.cache_shardings``)
        w = merge_weights(ll, torch.ones(n, device=ll.device))[r][..., None]
        return torch.where(w > 0, w * ol[0].float(), 0.0)

    return pj.local(weigh, summed, out, lse)


def _decode_sharded(q, k_c, v_c, lengths):
    """One token over a cache sequence-sharded on ``model``
    (``_read_sharded``): each rank reads its own T-slice, lengths_r =
    clamp(len - r T_loc, 0, T_loc)."""
    def read(lo, with_lse, kl, vl, ql, ll):
        lens = (ll.long() - lo).clamp(0, kl.shape[1])
        if not with_lse:
            return decode_mha(ql, kl, vl, lens)
        out, lse = decode_mha(ql, kl, vl, lens, return_lse=True)
        return out, lse[:, None]

    return _read_sharded(read, (k_c, v_c), (q, lengths))


def _segment_mesh(q, k, v, positions, theta: float, window: Optional[int],
                  cache, cache_pos):
    """A segment that continues a cache, on a mesh: the JAX package pins
    a cached read's cache on ('model' @ seq) with the q heads whole
    (layers.py:286-298), so this is a decode step's pattern with S queries:
    each rank writes the tokens whose slots fall in its T-slice and reads
    its slice through ``cache_mha``, merged by ``_read_sharded``."""
    q = constrain(q, BATCH, None, None, None)
    k = constrain(k, BATCH, None, None, None)
    v = constrain(v, BATCH, None, None, None)
    positions = constrain(positions, BATCH, None)
    q, k = _rope_local(q, k, positions, theta)
    _write_segment_sharded(cache, k, v, positions, cache_pos, window)
    k_c = constrain(cache["k"].to(q.dtype), BATCH, "model", None, None)
    v_c = constrain(cache["v"].to(q.dtype), BATCH, "model", None, None)
    p_c = constrain(cache["pos"], BATCH, "model")

    def read(lo, with_lse, kl, vl, kpl, ql, qpl):
        return cache_mha(ql, kl, vl, qpl, kpl, window, return_lse=with_lse)

    out = _read_sharded(read, (k_c, v_c, p_c), (q, positions))
    return constrain(out, BATCH, None, None, None).to(q.dtype)


def _mesh_attention(q, k, v, positions, cfg: ArchConfig,
                    window: Optional[int], cache, cache_pos):
    """``attention_apply``'s core on a mesh: q, k, v (B, S, H|Hkv, D) and
    positions (B, S) are DTensors; returns the attention output (B, S, H,
    D) before the output projection.  The cached cases are the one-device
    path's: with a window a decode step writes slot cache_pos % T of the
    ring and reads its min(cache_pos + 1, T) written slots, each rank its
    own T-slice of them; a segment that continues a cache goes through
    ``_segment_mesh``."""
    theta = cfg.rope_theta
    s = q.shape[1]
    if cache is not None and s == 1:
        # decode reads keep the cache sequence-sharded (JAX's layers.py
        # :291-298): q heads replicated, the cache on ('model' @ seq)
        q = constrain(q, BATCH, None, None, None)
        k = constrain(k, BATCH, None, None, None)
        v = constrain(v, BATCH, None, None, None)
        positions = constrain(positions, BATCH, None)
        q, k = _rope_local(q, k, positions, theta)
        t = cache["k"].shape[1]
        slot, lengths = cache_pos, cache_pos + 1
        if window is not None:
            slot, lengths = cache_pos % t, torch.clamp(lengths, max=t)
        _write_decode(cache, k, v, positions, slot)
        k_c = constrain(cache["k"].to(q.dtype), BATCH, "model", None, None)
        v_c = constrain(cache["v"].to(q.dtype), BATCH, "model", None, None)
        out = _decode_sharded(q, k_c, v_c, lengths)
        return constrain(out, BATCH, None, None, None).to(q.dtype)
    if cache is not None:
        t = cache["k"].shape[1]
        if not (s == t or (s < t and bool(
                (cache_pos.full_tensor() == 0).all()))):
            return _segment_mesh(q, k, v, positions, theta, window, cache,
                                 cache_pos)
    q = constrain(q, BATCH, None, "model", None)
    k = constrain(k, BATCH, None, "model", None)
    v = constrain(v, BATCH, None, "model", None)
    positions = constrain(positions, BATCH, None)
    q, k = _rope_local(q, k, positions, theta)
    if cache is not None:
        _write_prefill(cache, k, v, positions)
    return _flash_local(q, k, v, window)


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int,
                    window: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    t = min(window, max_len) if window is not None else max_len
    return {
        "k": torch.zeros((batch, t, cfg.n_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, t, cfg.n_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, t), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    down_scale = 0.02 / max(1, cfg.n_layers) ** 0.5
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, f),
                "w_up": dense_init(gen, d, f),
                "w_down": dense_init(gen, f, d, scale=down_scale)}
    if cfg.mlp == "gelu":
        return {"w_in": dense_init(gen, d, f),
                "w_down": dense_init(gen, f, d, scale=down_scale)}
    raise ValueError(f"unknown mlp {cfg.mlp!r}")


def mlp_apply(params: Params, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        gate = matmul(x, params["w_gate"].to(dt))
        gate = (F.silu(gate) if cfg.mlp == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        up = matmul(x, params["w_up"].to(dt))
        return matmul(gate * up, params["w_down"].to(dt))
    hidden = F.gelu(matmul(x, params["w_in"].to(dt)), approximate="tanh")
    return matmul(hidden, params["w_down"].to(dt))
