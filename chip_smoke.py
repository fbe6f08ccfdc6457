"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:

1. the card's name and power limit, the torch and CUDA versions;
2. build the four kernels (SDCA, flash attention, decode attention, cache
   attention) from ``src/repro_torch/kernels/*/csrc`` with nvcc (one
   process per source, started together); print registers, spills and
   shared memory of the SDCA kernel, the CUDA-core and tensor-core flash
   kernels, the split and merge decode kernels and the CUDA-core and
   tensor-core cache attention kernels and their merge;
3. hold each kernel against its plain PyTorch version on the card: SDCA at
   the MOCHA main path's shapes (Vehicle Sensor: gram mode; Human
   Activity: carry mode), forced modes both ways, budgets that end
   mid-chunk, n not a multiple of the chunk, d = 3 (mod 4), d 1000 (r
   wider than the registers), duplicate-heavy streams, the "global"
   kind's one pooled task of every Vehicle Sensor client's rows (one pass
   and budgets ending mid-chunk), and
   budget 0 and mask 0 (exact no-ops), and the cohort path's shape (K 256
   x n_pad 64 x d 32, dropped slots at budget 0, padded rows at mask 0,
   both exactly 0); flash and decode at the cases of
   tests/test_kernels.py, a ragged S and T, and SmolLM-360M's shapes, in
   f32 and bf16; flash f32 at every head_dim with a ragged S, windows and
   GQA; flash bf16 (wgmma + TMA) at head_dim 128 and 256 and with
   one-hot probabilities; decode at lengths on the split's chunk
   boundaries, also against the plain split-and-merge; flash (the CUDA-core
   kernel, f32 and bf16: ragged S, causal, windows, GQA) and decode
   (ragged lengths) at head_dim 112, zamba2-7b's; decode's slots past
   lengths (bitwise no influence); and decode's log-sum-exp output
   (``return_lse``) against the plain version's at head_dim 64, 112 and
   128, lengths 0 included (-inf there), the output unchanged bit for bit;
   cache attention (a segment over a whole cache masked by the positions
   it holds) at SmolLM-360M's 256-token segment over 1,064 slots (with
   and without a window), zamba2-7b's 64 tokens over 328 slots at head_dim
   112 (split over the slots), a mixtral-like window of 4,096, a ragged
   case and one query at head_dim 256, f32 and bf16 (bf16 at head_dim 64,
   112, 128, 256 on the tensor cores, within ``cache_tolerance``), row 0
   of each all masked (the mean of V), and its ``return_lse`` against the
   plain
   version's (-inf on the all-masked rows, the output unchanged bit for
   bit);
4. the MOCHA main path: full-size experiments through
   ``repro_torch.api.Experiment.run`` with ``engine="kernel"``, every launch
   counter set to 0 just before each and read just after, then the same
   experiments with ``engine="local"`` (the plain solver) on the card, both
   on the loop driver, and a small problem held against a CPU run;
5. the MOCHA evaluation path (``phase_eval_path``): (a) the pre-sampled
   driver (a CUDA graph per round) against the loop driver on the local
   engine, bit for bit, at Vehicle Sensor and Human Activity, with walls
   per round and the capture time; (b) the Table-1 MTL grid at
   Vehicle Sensor (10 shuffles x 9 lambdas) through the batched sweep,
   held out on the test split; (c) the same cells through the grid path on
   the kernel engine (one launch per round per cell, counters set to 0
   just before and read just after), every cell held against the sweep's,
   and the "global" kind through the kernel grid; (d) Mb-SGD and Mb-SDCA
   on the card against the CPU;
6. the cross-device cohort path (``phase_cohort_path``), with the protocol
   constants of ``benchmarks/cohort_scale.py`` and ``faults_scale.py``:
   (a) CROSS_DEVICE_1M (10^6 clients) at K 64 and 256, 8 blocks, overlap 1
   and 4 at staleness 0, on the local engine (one captured round program a
   run, counted) and the kernel engine (one SDCA launch a block, counters
   set to 0 just before each run and read just after), cold and warm
   walls, blocks/s and clients/s, overlap 4 equal to overlap 1 bit for bit,
   the kernel engine's history against the local engine's; (b) faults at
   f = 0.25 with degradation inside the 10% envelope of the fault-free
   primal, and a run crashed at block 6 and resumed from its checkpoints
   equal to the uninterrupted run bit for bit; (c) a small population on
   the card against the CPU with telemetry on, the Chrome trace validated;
   the SDCA kernel timed at the K 256 shape; then the MOCHA serving tier
   (``phase_serve_tier``): ``Experiment.serve()`` over CROSS_DEVICE_1M at
   K 256, a snapshot published every fold, training on a background
   thread (the kernel engine at overlap 1 and 4, the local engine at
   overlap 4) while this thread predicts batches of 1,024 uniform clients:
   serving on equal to ``Experiment.run`` bit for bit, every answer equal
   to the host rule of its snapshot, max version lag <= 1, 8 publishes +
   the prewarm, one SDCA launch a kernel-engine block, one capture a
   local-engine run; predict p50 / p99 and lookups/s; then the sharded
   runtime (``phase_sharded_path``, ``Exec(engine="sharded")``, loop
   driver; no kernel): (a) one NCCL rank at Vehicle Sensor and Human
   Activity, alpha, v, W, Omega and history equal to the local engine's
   bit for bit, walls per round beside the local engine's; (b) the bf16
   wire at Vehicle Sensor against the same run on the CPU (dual and
   primal rtol 1e-5 / atol 1e-4, the gap within its terms' sum), and its
   distance from the f32 wire; (c) the cohort path at cohort_ref's shape
   with the sharded inner engine, equal to the local engine bit for bit;
   (d) two gloo ranks sharing the card (spawned ``chip_smoke.py
   --sharded-rank``), equal to each other bit for bit and to the local
   engine within the run contract; every ``torch.distributed`` collective
   counted, with its shape and bytes, a round; (e), between (c) and (d),
   ``repro_torch.examples.sharded_lm``'s SmolLM-360M train step and a
   short generate (4 of 32 layers) on a 1 x 1 mesh over the one NCCL
   rank, without ``gloo_collectives``, held against one device under the
   mesh-step limits, flash and decode launched, under 30 s (a 1 x 1 mesh
   carries no real collective: the wiring only);
7. the LM main path: SmolLM-360M at full width (random weights from seed
   0) through ``repro_torch.serve.Engine.generate``, batch 8, prompt 1024,
   32 new tokens, in f32 and bf16, through the kernels (counters set to 0
   just before each generate and read just after: 32 flash and 992 decode
   launches) and through the plain versions on the card, logits (the plain
   route fed the kernel route's tokens) and greedy tokens compared (the
   plain route swaps the plain versions into
   ``repro_torch.models.layers`` for the comparison); a reduced SmolLM on
   the card against the CPU; then the personalization bridge
   (``phase_personalize``) on SmolLM-360M: features of 8 tasks of 16-72
   sequences of 128 tokens through the flash kernel (every call within
   ``flash_tolerance``, the features within 1e-4 of the plain route), MOCHA
   per-task heads with smooth_hinge on the local engine and hinge on the
   kernel engine at d 960 (the SDCA kernel's wide carry, also timed) held
   against the local engine's hinge run; and LM training (``phase_train``)
   of SmolLM-360M at B 4 x S 512, five AdamW steps in f32 and in bf16 with
   f32 masters, step 0 of the kernel route against the plain route (its
   every flash call within ``flash_tolerance``; two planted wrong flash
   routes must fail the same limits), the loss falling, 64 flash launches
   a step (the forward's and ``cfg.remat``'s recompute's); remat
   (``phase_remat``): rwkv6-7b at full width, 2 layers, B 1 x 4096, bf16,
   the step's gradients with each block recomputed against the step
   without, within TRAIN_TOL, both peaks printed; then the other model
   families (``phase_families``) at their
   published widths, random weights from seed 0, through
   ``Engine.generate`` with 16 new tokens in f32 and bf16: mixtral-8x7b (4
   of 32 layers; B 1, a 4096-token prompt filling its 4096-slot ring, which
   the decode steps wrap), granite-moe-1b-a400m, llava-next-mistral-7b
   (1152 image embeddings + 128 text tokens), musicgen-medium (4
   codebooks), rwkv6-7b and zamba2-7b (81 mamba2 blocks, 13 shared
   attention calls at head_dim 112), B 2 x 256 unless said; launches held
   to the attention calls a forward (flash) and 15 x that (decode), the
   plain route fed the kernel route's tokens within LOGIT_TOL (in bf16 the
   MoE families' plain route takes the kernel route's expert choices;
   its own are reported), greedy tokens equal in f32; mixtral's decode
   steps past the ring's end against the windowed full-sequence forward
   over the same 4112 tokens; the card freed between families; then a
   prompt continued over several ``Model.prefill`` calls on one cache
   (``phase_cache_segments``, under 60 s): SmolLM-360M (32 layers, B 8)
   with its 1,024-token prompt in four 256-token calls then 32 decode
   steps, f32 and bf16, against the one-shot prefill and the plain route
   (f32 tokens equal); mixtral-8x7b (4 of 32 layers, B 1) a 4,096-token
   prompt then 256 tokens into the wrapped ring, and a 6,144-token prompt
   into the 4,096-slot ring; zamba2-7b (7 of 81 layers) 256 + 64 tokens
   at head_dim 112; every cache_attention call held against its plain
   version on its own inputs, the launches counted; then the
   launch plan (``phase_dryrun``): ``repro_torch.launch.dryrun`` over 10
   archs x 4 shapes x both production meshes against the card's memory,
   per-device GiB by part, and every case that fits the free memory
   allocated as rank 0's shards, the allocator's requested bytes equal
   to the plan's argument bytes exactly; then the dry-run's compiler half
   (``phase_dryrun_costs``, in a process of its own, ``chip_smoke.py
   --dryrun-costs``): ``dryrun --costs`` for smollm-360m train_4k,
   mixtral-8x7b decode_32k, rwkv6-7b train_4k and zamba2-7b prefill_32k on
   pod16x16, each step as rank 0 of a fake 256-rank process group: FLOPs,
   bytes and collective bytes a device from the CPU probe on FakeTensors
   and the temp bytes from the card (the kernel route on rank 0's real
   shards), each differenced to full depth, the card's DTensor
   collectives at each depth equal to the CPU probe's by kind and bytes,
   smollm-360m's differenced temp bytes within 10% of a 32-layer run,
   rwkv6-7b train_4k's within the card's memory, mixtral-8x7b train_4k's
   temp bytes from the card alone; the
   MOCHA round (``launch.mocha_dryrun``) at m 512, d 561 with the f32 and
   the bf16 wire, one all-gather of m x d; within 90 s; no process group
   left in the script's process;
8. time the SDCA kernel (CUDA events over many launches) beside its bound
   and its chain floor (a model printed on the timing line: chain steps x
   one dependent step counted from the kernel's instructions at assumed
   latencies), its plain version and the wall time per
   round of both engines on the loop driver; profile three kernel-engine rounds
   (``torch.profiler``);
9. time flash and decode at SmolLM-360M's shapes and at zamba2-7b's
   head_dim 112 (kernel, plain version,
   ``scaled_dot_product_attention``) beside their bounds, with each
   kernel's design and share of the bound; cache attention at the
   segments' shapes (SmolLM-360M, zamba2-7b, mixtral-8x7b) beside SDPA
   with the boolean mask (built outside the timed call); prefill ms and
   decode ms per token of both routes; profile a prefill and decode steps in f32 and
   bf16, each attention kernel's device time per call beside its bound;
10. profile two warm blocks of the cohort path at K 256 on each engine
   (``phase_cohort_profile``), then two rounds of each driver on the local
   engine at Vehicle Sensor: replays of the pre-sampled driver's own
   program and a loop run (device kernels and busy share per round);
11. last (its four extra processes on the card perturb no timing), the
   sharded LM step (``phase_mesh_step``) on a 2 x 2 mesh of four gloo
   ranks sharing the card (spawned ``chip_smoke.py --mesh-rank``), through
   ``repro_torch.examples.sharded_lm``'s runs and checks (its four-card
   NCCL run is a call of its own, under ``torch.distributed.run``):
   SmolLM-360M at full width (8 of 32 layers), two AdamW steps in bf16
   with f32 masters at B 4 x 512 (batch over ('data', 'model')) and two
   in f32 at B 2 x 512, a generate of 8 tokens at B 8 after a 1024-token
   prompt in f32 and bf16 (once in one prefill call, once in four on one
   cache, the later three through the cache attention kernel on each
   rank's T-slice), and granite-3-2b's (20 of 40 layers, heads
   split over 'model') at B 2 x 256 in bf16, each held against the same run on one device of
   the card (ce, grad_norm, logits, tokens), flash and decode launched on
   every rank, no decode step gathering the sequence-sharded cache,
   DTensor's collectives a step counted;
12. then the same for the other attention-block families and the
   window's ring (``phase_mesh_families``): granite-moe-1b-a400m (12 of
   24 layers; two bf16 AdamW steps at B 4 x 512, 4 routing groups; a
   generate of B 2 x 256 in f32 and bf16), mixtral-8x7b (1 of 32 layers,
   B 1 x 4096 filling its 4096-slot ring, 2,048 slots a rank),
   musicgen-medium (24 of 48 layers) and llava-next-mistral-7b (2 of 32
   layers, 1,152 image embeds) in bf16,
   each against the one-device run under the same context (MoE in bf16
   on the one-device run's expert choices, its own flips counted);
13. then the same for the recurrent families (``phase_mesh_recurrent``):
   rwkv6-7b (2 of 32 layers; two bf16 AdamW steps at B 4 x 512, the
   batch over ('data', 'model'); a generate of B 2 x 256 in f32 and bf16,
   the 64 heads over 'model') and zamba2-7b (7 of 81 layers: a period
   of six mamba2 blocks with the shared attention block, and a tail
   block; two bf16 steps at B 2 x 512, the SSM and attention heads over
   'model'; a generate of B 2 x 256 in f32 and bf16), the states held in
   the plan's placements after prefill and every decode step and never
   gathered in a decode step.

It prints the kernel table as JSON, its own seconds, the card line, and
last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  Exits nonzero,
printing no result, where CUDA is absent or the package is not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: kernel vs plain version, relative to max(1, max |plain output|): the two
#: take their reductions in another order, nothing else
KERNEL_TOL = 2e-5
#: kernel-engine vs local-engine histories on the card (relative); ten
#: rounds of the same draws, solves differing at rounding level
HISTORY_RTOL = 1e-4
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
ROUNDS = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_case(spec, *, seed=0, gram=None, dup=False, zero_budget=False,
                zero_mask=False, mid_chunk=False, pooled=False,
                device="cuda"):
    """Kernel inputs at a federation's shapes as a MOCHA round makes them:
    the federation's X/y/mask and row norms, a feasible alpha, a small W,
    one-pass budgets, coordinate streams drawn from the port's PRNG.
    ``mid_chunk``: budgets of 3/8 of a pass, none a multiple of the
    chunk.  ``pooled``: the "global" kind's one task of every client's rows
    (``make_global_problem``)."""
    from repro_torch.data.synthetic import make_federation, make_global_problem
    data = make_federation(spec, seed=0, device=device)[0]
    if pooled:
        data = make_global_problem(data)
    return federation_case(data, seed=seed, gram=gram, dup=dup,
                           zero_budget=zero_budget, zero_mask=zero_mask,
                           mid_chunk=mid_chunk)


def federation_case(data, *, seed=0, gram=None, dup=False,
                    zero_budget=False, zero_mask=False, mid_chunk=False):
    """``kernel_case`` of a federation already on the card."""
    from repro_torch.core.dual import with_xnorm2
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    data = with_xnorm2(data)
    m, n, d = data.X.shape
    rng = np.random.default_rng(seed)
    dev = data.X.device

    def on(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    alpha = (data.y * data.mask * on(rng.uniform(0, 1, (m, n)))).contiguous()
    W = on(0.1 * rng.normal(size=(m, d)))
    q = on(rng.uniform(0.5, 2.0, m))
    budgets = torch.round(data.n_t).to(torch.int32)
    keys = prng.split(prng.PRNGKey(seed, device=dev), m)
    idx = draw_coordinates(keys, data.n_t, n, n)
    mask = data.mask
    if dup:
        idx = idx % 4
    if mid_chunk:
        budgets = (3 * budgets) // 8
        budgets = budgets + (budgets % 16 == 0).to(budgets.dtype)
    if zero_budget:
        budgets = torch.zeros_like(budgets)
    if zero_mask:
        mask = torch.zeros_like(mask)
    return dict(X=data.X, y=data.y, mask=mask, alpha=alpha, W=W, q_t=q,
                budgets=budgets, idx=idx, max_steps=n, gram=gram,
                xnorm2=data.xnorm2)


def _plain_args(case):
    return {k: v for k, v in case.items() if k != "max_steps"}


def check_kernel(label, case, tol):
    from repro_torch.kernels.sdca import sdca_local_solve, sdca_ref
    da, u = sdca_local_solve(**case)
    dr, ur = sdca_ref(**_plain_args(case))
    torch.cuda.synchronize()
    if not (torch.isfinite(da).all() and torch.isfinite(u).all()):
        raise AssertionError(f"kernel output not finite: {label}")
    err = max(float((da - dr).abs().max()), float((u - ur).abs().max()))
    scale = max(float(dr.abs().max()), float(ur.abs().max()), 1.0)
    ok = err <= tol * scale
    print(f"kernel vs plain [{label}]: max_abs_err={err:.3e} "
          f"(tolerance {tol:g} x {scale:.3g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain version: {label}")
    return err


def ptxas_summary(log):
    """{kernel function: registers, spill bytes, stack} from nvcc's
    ``-Xptxas -v`` log."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = dict(registers=None, spill_stores=0, spill_loads=0,
                           stack=0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes cumulative "
                      r"stack size)?$", line)
        if m and fn:
            out[fn].update(registers=int(m.group(1)),
                           stack=int(m.group(2) or 0))
    return out


def phase_build():
    """Build the four sources; print nvcc's log and, for the SDCA kernel,
    the CUDA-core and tensor-core flash kernels, the split and merge
    decode kernels and the cache attention kernel and its merge,
    registers, spills and the dynamic shared memory a block asks for.
    Fails if the bf16 flash kernel at head_dim 112 (zamba2-7b's
    tensor-core instance) spills."""
    import importlib
    from repro_torch.kernels import build
    FA, DA, SD = (importlib.import_module(f"repro_torch.kernels.{n}.{n}")
                  for n in ("flash_attention", "decode_attention", "sdca"))
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(build.SOURCES)}, nvcc {' '.join(build.NVCC_FLAGS)} "
          f"-I{build.INCLUDE_DIR}")
    log = build.LAST_BUILD.get("log", "")
    print(log.strip(), flush=True)
    flash = build.load("flash_attention", FA._bind)
    decode = build.load("decode_attention", DA._bind)
    sdca = build.load("sdca", SD._bind)
    summary = ptxas_summary(log)
    wgmma112 = [r for fn, r in summary.items()
                if "flash_wgmma_kernelILi112E" in fn]
    if "nvcc flash_attention.cu" in log and not (
            wgmma112 and wgmma112[0]["spill_stores"] == 0
            and wgmma112[0]["spill_loads"] == 0):
        raise AssertionError(f"the bf16 flash kernel at head_dim 112 is not "
                             f"built or spills: {wgmma112}")
    for fn, r in summary.items():
        if "sdca_kernel" in fn:
            from repro_torch.core.subproblem import _solver_plan
            from repro_torch.data.synthetic import (HUMAN_ACTIVITY,
                                                    VEHICLE_SENSOR,
                                                    make_federation)
            smem = []
            for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY):
                _, n, d = make_federation(spec, seed=0)[0].X.shape
                gram, C = _solver_plan(d, n)
                nbytes = sdca.sdca_shared_bytes(n, d, C, int(gram),
                                                torch.cuda.current_device())
                smem.append(f"{spec.name} {nbytes} B")
            print(f"ptxas [sdca_kernel]: {r['registers']} registers, spill "
                  f"stores {r['spill_stores']} B, spill loads "
                  f"{r['spill_loads']} B, stack {r['stack']} B, dynamic "
                  f"shared memory {', '.join(smem)}", flush=True)
            continue
        for kind in ("flash_kernel", "flash_wgmma_kernel",
                     "decode_split_kernel", "decode_merge_kernel",
                     "cache_attention_kernel", "cache_wgmma_kernel",
                     "cache_merge_kernel"):
            if kind not in fn:
                continue
            d = int(fn.split(kind)[1].split("Li")[1].split("E")[0])
            dt = 1 if "bfloat16" in fn or "wgmma" in kind else 0
            if kind.startswith("flash"):
                smem = flash.flash_attention_shared_bytes(d, dt)
            elif kind == "decode_split_kernel":   # the main path's G, chunk
                smem = decode.decode_attention_shared_bytes(3, d, 128, dt)
            elif kind in ("cache_attention_kernel", "cache_wgmma_kernel"):
                from repro_torch.kernels.cache_attention import shared_bytes
                smem = shared_bytes(d, (torch.float32, torch.bfloat16)[dt])
            else:
                smem = 0
            print(f"ptxas [{kind} {'bf16' if dt else 'f32'} D{d}]: "
                  f"{r['registers']} registers, spill stores "
                  f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, "
                  f"stack {r['stack']} B, dynamic shared memory {smem} B",
                  flush=True)


def phase_kernels():
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    errs = {
        "gram": check_kernel("vehicle_sensor, gram",
                             kernel_case(VEHICLE_SENSOR), KERNEL_TOL),
        "carry": check_kernel("human_activity, carry",
                              kernel_case(HUMAN_ACTIVITY), KERNEL_TOL),
    }
    d120 = dataclasses.replace(VEHICLE_SENSOR, name="vs_d120", d=120)
    ragged = dataclasses.replace(VEHICLE_SENSOR, name="vs_n750",
                                 n_min=1001, n_max=1001)   # 750 train rows
    errs["budgets"] = max(
        check_kernel(f"{spec.name}, budgets ending mid-chunk",
                     kernel_case(spec, mid_chunk=True), KERNEL_TOL)
        for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY, ragged))
    errs["forced"] = max(
        check_kernel("d=120, forced gram", kernel_case(d120, gram=True),
                     KERNEL_TOL),
        check_kernel("human_activity, forced gram (d 561 in gram mode)",
                     kernel_case(HUMAN_ACTIVITY, gram=True), KERNEL_TOL),
        check_kernel("vehicle_sensor, forced carry",
                     kernel_case(VEHICLE_SENSOR, gram=False), KERNEL_TOL))
    errs["duplicates"] = max(
        [check_kernel(f"{spec.name}, duplicate-heavy idx",
                      kernel_case(spec, dup=True), KERNEL_TOL)
         for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY)]
        + [check_kernel("vehicle_sensor, duplicate-heavy idx, forced carry",
                        kernel_case(VEHICLE_SENSOR, dup=True, gram=False),
                        KERNEL_TOL),
           check_kernel("human_activity, duplicate-heavy idx, forced gram",
                        kernel_case(HUMAN_ACTIVITY, dup=True, gram=True),
                        KERNEL_TOL)])
    # d = 3 (mod 4): a slot of the carry buffer holds rows of different
    # lengths from chunk to chunk; d 1000: r wider than the registers (carry
    # with r in shared memory)
    errs["widths"] = max(
        check_kernel(label, kernel_case(spec, gram=gram), KERNEL_TOL)
        for label, spec, gram in (
            ("d=563, carry", dataclasses.replace(
                HUMAN_ACTIVITY, name="ha_d563", d=563), None),
            ("d=99, forced carry", dataclasses.replace(
                VEHICLE_SENSOR, name="vs_d99", d=99), False),
            ("d=1000, wide carry", dataclasses.replace(
                HUMAN_ACTIVITY, name="ha_d1000", d=1000), None)))
    # the "global" kind of the kernel grid (phase_eval_path): one task of
    # every Vehicle Sensor client's rows, ~1,025 gram chunks in one block
    errs["global"] = max(
        check_kernel(f"vehicle_sensor pooled, {label}",
                     kernel_case(VEHICLE_SENSOR, pooled=True, mid_chunk=mid),
                     KERNEL_TOL)
        for label, mid in (("one pass", False),
                           ("budgets ending mid-chunk", True)))
    # the cohort path's shape: K 256 clients of CROSS_DEVICE_1M packed to
    # n_pad 64, d 32 (gram), 10% of the slots dropped to budget 0 and the
    # rows past each client's n_t at mask 0 (phase_cohort_path)
    case = cohort_kernel_case(256)
    errs["cohort"] = check_kernel("cross_device_1m K=256 n_pad=64 d=32, "
                                  "dropped slots and padded rows", case,
                                  KERNEL_TOL)
    from repro_torch.kernels.sdca import sdca_local_solve
    da, u = sdca_local_solve(**case)
    dropped = case["budgets"] == 0
    if not dropped.any() or torch.any(da[dropped]) or torch.any(
            u[dropped]) or torch.any(da * (1 - case["mask"])):
        raise AssertionError("cohort shape: a dropped slot or a padded row "
                             "moved")
    print("kernel [cohort shape]: dropped slots (budget 0) and padded rows "
          "(mask 0) exactly 0", flush=True)
    for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY):
        for kw in ("zero_budget", "zero_mask"):
            check_kernel(f"{spec.name}, {kw} (exact no-op)",
                         kernel_case(spec, **{kw: True}), 0.0)
    return errs


def _experiment(spec, reg, engine, every):
    """The main path's experiment on ``engine``, on the loop driver: the
    kernel engine has no other, and the local engine's walls here stay
    those of the loop (phase_eval_path times the pre-sampled driver)."""
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.data.synthetic import make_federation
    train, test = make_federation(spec, seed=0)   # on the card
    return Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=(reg,), rounds=ROUNDS,
                      omega_update_every=every),
        exec=Exec(engine=engine, driver="loop"),
        eval=Eval(record_every=1)), test


def _run_timed(exp):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = exp.run(seed=0)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def _compare_histories(label, a, b):
    worst = 0.0
    for k in ("dual", "primal", "gap"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        scale = np.maximum(np.abs(np.asarray(a["primal"])), 1.0)
        rel = float(np.max(np.abs(x - y) / scale))
        worst = max(worst, rel)
        if not np.all(np.isfinite(x)) or rel > HISTORY_RTOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.3e} of "
                                 f"|primal| (tolerance {HISTORY_RTOL:g})")
    return worst


def phase_main_path():
    """The main path: full-size experiments, kernel engine then local,
    both on the loop driver."""
    from repro_torch.core import Clustered, MeanRegularized, per_task_error
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    cases = [("vehicle_sensor", VEHICLE_SENSOR, Clustered(lam=1.0, k=3), 5),
             ("human_activity", HUMAN_ACTIVITY, MeanRegularized(), 0)]
    out = {}
    for label, spec, reg, every in cases:
        exp_k, test = _experiment(spec, reg, "kernel", every)
        reset_all_counts()
        rep_k, wall_k = _run_timed(exp_k)
        launches = read_counts()["sdca_local_solve"]
        if launches != ROUNDS:
            raise AssertionError(f"{label}: the kernel ran {launches} times "
                                 f"in {ROUNDS} rounds")
        exp_l, _ = _experiment(spec, reg, "local", every)
        rep_l, wall_l = _run_timed(exp_l)
        rel = _compare_histories(label, rep_k.history, rep_l.history)
        W = torch.from_numpy(rep_k.result.W).to(test.X.device)
        err = float(per_task_error(test, W, test.X, test.y,
                                   test.mask).mean())
        prov = rep_k.provenance
        print(f"main path [{label}] m={test.m} d={test.d} "
              f"{prov['gram_mode']} mode, {ROUNDS} rounds, "
              f"omega_update_every={every}: launches={launches}, final gap "
              f"kernel {rep_k.final('gap'):.6g} local {rep_l.final('gap'):.6g}"
              f", history max rel diff {rel:.3e}, mean test error "
              f"{err:.4f}, wall/round (loop driver) kernel "
              f"{1e3 * wall_k / ROUNDS:.2f} ms "
              f"local {1e3 * wall_l / ROUNDS:.2f} ms", flush=True)
        out[label] = dict(launches=launches, exp_k=exp_k, exp_l=exp_l,
                          wall_ms=[1e3 * wall_k / ROUNDS,
                                   1e3 * wall_l / ROUNDS])
    return out


def phase_small_reference():
    """A tiny problem through the kernel engine on the card, held against
    the same experiment run on the CPU (plain solver)."""
    from repro_torch.api import Exec, Experiment, Method, Problem
    from repro_torch.core import Clustered
    from repro_torch.data.synthetic import tiny_problem
    train = tiny_problem(m=4, n=24, d=6, seed=0, device="cpu")[0]
    reps = [Experiment(problem=Problem(train=train),
                       method=Method(regularizers=(Clustered(),), rounds=8,
                                     omega_update_every=3),
                       exec=Exec(engine="kernel", device=dev)).run(0)
            for dev in ("cuda", "cpu")]
    rel = _compare_histories("tiny cuda vs cpu", reps[0].history,
                             reps[1].history)
    print(f"small reference [tiny, cuda kernel vs cpu plain]: history max "
          f"rel diff {rel:.3e}", flush=True)


# ---------------------------------------------------------------------------
# The MOCHA evaluation path: the pre-sampled driver, the grids, held-out
# evaluation and the mini-batch baselines
# ---------------------------------------------------------------------------

#: the Table-1 protocol's full lambda grid and shuffle count
#: (benchmarks/common.py LAMBDAS_FULL, SHUFFLES_FULL)
EVAL_LAMBDAS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0)
EVAL_SHUFFLES = 10
GLOBAL_SHUFFLES = 3
#: a grid cell against the single run of that cell, and a card run against
#: the CPU (the parity contract): objectives rtol / atol, W and Omega
#: rtol / atol; float32 sums in another order over ten rounds.  Between
#: the kernel and the plain solver (the kernel grid against the sweep) the
#: W and Omega atol scales with max(1, max|x|) of the cell, as the
#: kernel-vs-plain rule scales with the largest output: an entry that is
#: small by cancellation carries the rounding of the cell's largest terms
#: (at lambda 1e-4 max|W| is ~9)
OBJ_TOL = (1e-5, 1e-4)
W_TOL = (1e-4, 1e-5)


def _close(label, got, want, tol, scale=1.0):
    """|got - want| <= rtol |want| + atol scale, element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = tol
    err = np.abs(got - want)
    if not (np.all(np.isfinite(got))
            and np.all(err <= atol * scale + rtol * np.abs(want))):
        raise AssertionError(f"{label}: max |diff| {err.max():.3e} beyond "
                             f"rtol {rtol:g} / atol {atol:g} x {scale:.3g}")
    return float(err.max())


def _local_exp(train, reg, driver, every, rounds=None):
    from repro_torch.api import Exec, Experiment, Method, Problem
    return Experiment(problem=Problem(train=train),
                      method=Method(loss="hinge", regularizers=(reg,),
                                    rounds=rounds or ROUNDS,
                                    omega_update_every=every),
                      exec=Exec(engine="local", driver=driver))


def eval_drivers(label, spec, reg, every):
    """(a) The loop and the pre-sampled driver on the local engine: the same
    bits; wall per round of each and the capture time.  The main path ran
    the loop at these shapes before; a 2-round scanned run warms the
    pre-sampled driver up."""
    from repro_torch.data.synthetic import make_federation
    train = make_federation(spec, seed=0)[0]
    _run_timed(_local_exp(train, reg, "scan", every, rounds=2))
    loop, wall_loop = _run_timed(_local_exp(train, reg, "loop", every))
    scan, wall_scan = _run_timed(_local_exp(train, reg, "scan", every))
    if scan.provenance["driver"] != "scan" or scan.result.capture_s is None:
        raise AssertionError(f"{label}: the scanned run captured no graph")
    if loop.history != scan.history or not all(
            np.array_equal(getattr(loop.result, k), getattr(scan.result, k))
            for k in ("W", "omega", "round_budgets")):
        raise AssertionError(f"{label}: the scanned driver's bits differ "
                             "from the loop driver's")
    capture = scan.result.capture_s
    row = dict(loop_ms_per_round=1e3 * wall_loop / ROUNDS,
               scan_ms_per_round=1e3 * wall_scan / ROUNDS,
               scan_ms_per_round_after_capture=1e3 * (wall_scan - capture)
               / ROUNDS, capture_s=capture, final_gap=scan.final("gap"))
    print(f"eval (a) drivers [{label}] m={train.m} d={train.d} "
          f"{scan.provenance['gram_mode']}, {ROUNDS} rounds, omega every "
          f"{every}: scan == loop bit for bit (history, W, omega, "
          f"round_budgets); wall/round loop {row['loop_ms_per_round']:.2f} "
          f"ms, scan {row['scan_ms_per_round']:.2f} ms "
          f"({row['scan_ms_per_round_after_capture']:.2f} ms after the "
          f"capture), capture (warm-up round, capture, instantiation) "
          f"{capture:.3f} s [{card_line()}]", flush=True)
    return row


def _grid_exp(trains, tests, regs, every, engine):
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.core import BudgetConfig
    return Experiment(
        problem=Problem(train=trains),
        method=Method(loss="hinge", regularizers=regs, rounds=ROUNDS,
                      omega_update_every=every,
                      budget=BudgetConfig(passes=1.0)),
        exec=Exec(engine=engine),
        eval=Eval(record_every=ROUNDS, holdout=tests))


def _hold_cells(label, got, want):
    """Every (regularizer, shuffle) cell of two grid results, the kernel's
    against the plain solver's: (worst objective |diff|, worst W and Omega
    |diff| over max(1, max|x|) of its cell, that cell's max|x|)."""
    worst = 0.0
    for k in ("dual", "primal", "gap"):
        worst = max(worst, _close(f"{label} {k}", getattr(got, k),
                                  getattr(want, k), OBJ_TOL))
    worst_w, worst_scale = 0.0, 1.0
    R, S = want.W.shape[:2]
    for k in ("W", "omega"):
        for r in range(R):
            for s in range(S):
                x = getattr(want, k)[r, s]
                scale = max(1.0, float(np.abs(x).max()))
                err = _close(f"{label} {k} cell ({r}, {s})",
                             getattr(got, k)[r, s], x, W_TOL, scale)
                if err / scale > worst_w:
                    worst_w, worst_scale = err / scale, scale
    return worst, worst_w, worst_scale


def eval_grids():
    """(b) The Table-1 MTL grid at Vehicle Sensor through the batched sweep,
    held out on the test split; every cell held against the single run of
    that cell: (c) the grid path on the kernel engine over every shuffle
    (cell by cell through the core driver, one launch per round per cell)
    and two cells as single local-engine experiments; then the "global"
    kind (``make_global_problem``) through the kernel grid."""
    from repro_torch.core import MeanRegularized, Probabilistic
    from repro_torch.data.synthetic import (VEHICLE_SENSOR,
                                            make_federation,
                                            make_global_problem)
    card = card_line()
    splits = [make_federation(VEHICLE_SENSOR, seed=s)
              for s in range(EVAL_SHUFFLES)]
    trains, tests = [tr for tr, _ in splits], [te for _, te in splits]
    regs = tuple(Probabilistic(lam=lam, sigma2=10.0) for lam in EVAL_LAMBDAS)
    cells = len(regs) * EVAL_SHUFFLES
    sweep, wall_sweep = _run_timed(_grid_exp(trains, tests, regs, 5,
                                             "local"))
    if (sweep.provenance["path"], sweep.provenance["driver"]) != (
            "sweep", "vmap"):
        raise AssertionError(f"the grid took {sweep.provenance['path']}")
    ev = sweep.evaluation
    if not (np.all(np.isfinite(ev.grid)) and 0 < ev.summary[
            "best_mean_error"] < 0.5):
        raise AssertionError(f"sweep held-out errors {ev.summary}")
    capture = sweep.result.capture_s
    print(f"eval (b) sweep [vehicle_sensor, {EVAL_SHUFFLES} shuffles x "
          f"{len(regs)} lambdas, Probabilistic(sigma2=10), omega every 5, "
          f"{ROUNDS} rounds]: {cells} cells in one program, wall "
          f"{wall_sweep:.3f} s ({1e3 * wall_sweep / ROUNDS:.1f} ms per round"
          f" of the grid; capture {capture:.3f} s, "
          f"{1e3 * (wall_sweep - capture) / ROUNDS:.1f} ms per round after "
          f"it); held-out best-lambda mean test error "
          f"{ev.summary['best_mean_error']:.4f} +- "
          f"{ev.summary['best_stderr']:.4f} (stderr) [{card}]", flush=True)

    reset_all_counts()
    grid, wall_grid = _run_timed(_grid_exp(trains, tests, regs, 5, "kernel"))
    launches = read_counts()["sdca_local_solve"]
    if grid.provenance["path"] != "grid" or launches != cells * ROUNDS:
        raise AssertionError(f"kernel grid: path {grid.provenance['path']},"
                             f" {launches} launches for {cells} cells")
    worst, worst_w, worst_scale = _hold_cells("sweep vs kernel grid",
                                              sweep.result, grid.result)
    np.testing.assert_array_equal(grid.evaluation.grid.shape, ev.grid.shape)
    print(f"eval (c) kernel grid [vehicle_sensor, the same {cells} cells, "
          f"engine='kernel', path grid]: {launches} launches "
          f"({ROUNDS} per cell), wall {wall_grid:.3f} s "
          f"({1e3 * wall_grid / (cells * ROUNDS):.2f} ms per cell-round); "
          f"every cell within the sweep's: objectives max |diff| "
          f"{worst:.3e} (rtol {OBJ_TOL[0]:g} / atol {OBJ_TOL[1]:g}), W and "
          f"omega max |diff| {worst_w:.3e} of max(1, max|x|) of the cell "
          f"(that cell's max|x| {worst_scale:.3g}; rtol {W_TOL[0]:g} / atol "
          f"{W_TOL[1]:g} x that); best-lambda error "
          f"{grid.evaluation.summary['best_mean_error']:.4f} [{card}]",
          flush=True)
    diffs = {"objectives": [0.0], "W and omega": [0.0]}
    for r, s in ((0, 0), (len(regs) // 2, 0),
                 (len(regs) - 1, EVAL_SHUFFLES - 1)):
        one = _local_exp(trains[s], regs[r], "auto", 5).run(0)
        for k in ("dual", "primal", "gap"):
            diffs["objectives"].append(_close(
                f"cell ({r}, {s}) {k}", getattr(sweep.result, k)[r, s],
                one.final(k), OBJ_TOL))
        for k in ("W", "omega"):
            diffs["W and omega"].append(_close(
                f"cell ({r}, {s}) {k}", getattr(sweep.result, k)[r, s],
                getattr(one.result, k), W_TOL))
    print("eval (b) three cells against single local-engine runs (scanned, "
          "on a CUDA graph): max |diff| " + ", ".join(
              f"{k} {max(v):.3e}" for k, v in diffs.items())
          + f" (W and omega element by element, rtol {W_TOL[0]:g} / atol "
          f"{W_TOL[1]:g})", flush=True)

    gtrains = [make_global_problem(tr) for tr in trains[:GLOBAL_SHUFFLES]]
    gtests = [make_global_problem(te) for te in tests[:GLOBAL_SHUFFLES]]
    gregs = tuple(MeanRegularized(lambda1=0.0, lambda2=lam)
                  for lam in EVAL_LAMBDAS)
    reset_all_counts()
    glob, wall_glob = _run_timed(_grid_exp(gtrains, gtests, gregs, 0,
                                           "kernel"))
    glaunches = read_counts()["sdca_local_solve"]
    gcells = len(gregs) * GLOBAL_SHUFFLES
    gsum = glob.evaluation.summary
    if glaunches != gcells * ROUNDS or not (
            np.all(np.isfinite(glob.result.gap))
            and 0 < gsum["best_mean_error"] < 0.5):
        raise AssertionError(f"global kernel grid: {glaunches} launches, "
                             f"summary {gsum}")
    print(f"eval (c) global kind [vehicle_sensor pooled, one task of "
          f"{gtrains[0].n_max} rows, {GLOBAL_SHUFFLES} shuffles x "
          f"{len(gregs)} lambdas, kernel grid]: {glaunches} launches, wall "
          f"{wall_glob:.3f} s, best-lambda test error "
          f"{gsum['best_mean_error']:.4f} +- {gsum['best_stderr']:.4f} "
          f"(MTL {ev.summary['best_mean_error']:.4f}) [{card}]", flush=True)
    return dict(sweep_s=wall_sweep, sweep_capture_s=capture,
                kernel_grid_s=wall_grid,
                global_grid_s=wall_glob, cells=cells,
                kernel_grid_launches=launches, global_launches=glaunches,
                kernel_grid_worst_obj=worst, kernel_grid_worst_w=worst_w,
                mtl_best_error=ev.summary["best_mean_error"],
                mtl_best_stderr=ev.summary["best_stderr"],
                global_best_error=gsum["best_mean_error"])


def eval_minibatch():
    """(d) Mb-SGD and Mb-SDCA at Vehicle Sensor, 10 rounds, on the card and
    on the CPU from the same data and seed."""
    from repro_torch.core import (MeanRegularized, MiniBatchConfig,
                                  run_mb_sdca, run_mb_sgd)
    from repro_torch.data.synthetic import VEHICLE_SENSOR, make_federation
    cfg = MiniBatchConfig(loss="hinge", rounds=ROUNDS, batch=16, lr=0.05,
                          beta=8.0, seed=0)
    reg = MeanRegularized(lambda1=0.1, lambda2=0.1)
    out = {}
    for name, fn in (("mb_sgd", run_mb_sgd), ("mb_sdca", run_mb_sdca)):
        res = {}
        for dev in ("cuda", "cpu"):
            train = make_federation(VEHICLE_SENSOR, seed=0, device=dev)[0]
            res[dev] = fn(train, reg, cfg)
        err = max(_close(f"{name} {k}", res["cuda"].history[k],
                         res["cpu"].history[k], OBJ_TOL)
                  for k in res["cuda"].history if k not in ("round", "time"))
        _close(f"{name} W", res["cuda"].W, res["cpu"].W, W_TOL)
        out[name] = res["cuda"].final("primal")
        print(f"eval (d) {name} [vehicle_sensor, {ROUNDS} rounds]: final "
              f"primal {out[name]:.6g} (cpu {res['cpu'].final('primal'):.6g}"
              f"), history max |diff| {err:.3e}", flush=True)
    return out


def phase_eval_path():
    """The evaluation path, (a)-(d); the SDCA counter is set to 0 just
    before each kernel grid and read just after it."""
    from repro_torch.core import Clustered
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    t0 = time.perf_counter()
    drivers = {label: eval_drivers(label, spec, Clustered(lam=1.0, k=3), 5)
               for label, spec in (("vehicle_sensor", VEHICLE_SENSOR),
                                   ("human_activity", HUMAN_ACTIVITY))}
    grids = eval_grids()
    mb = eval_minibatch()
    wall = time.perf_counter() - t0
    print(f"eval path: {wall:.1f} s", flush=True)
    return dict(drivers=drivers, grids=grids, minibatch_primal=mb,
                wall_s=wall)


# ---------------------------------------------------------------------------
# The cross-device cohort path: population, sampler, packer, ClusterOmega and
# the fault-tolerant block loop, through the SDCA kernel
# ---------------------------------------------------------------------------

#: the cohort_scale protocol (benchmarks/cohort_scale.py: SYSTEMS, BASE at
#: m = 10^6 (CROSS_DEVICE_1M), FULL_K, ROUNDS, OVERLAP_DEPTH; weighted
#: sampler, dropout 0.1, Probabilistic(1e-2, 10), hinge, one pass)
COHORT_KS = (64, 256)
COHORT_BLOCKS = 8
COHORT_OVERLAP = 4
#: the faults_scale protocol (benchmarks/faults_scale.py: SPEC, ROUNDS,
#: COHORT, MAX_RETRIES, ENVELOPE, CRASH_BLOCK, CHECKPOINT_EVERY; the
#: acceptance fault rate f = 0.25, pack faults at f / 2, fold delays at f)
FAULT_SPEC = dict(name="faults_bench", m=2000, d=16, n_min=16, n_max=48,
                  clusters=3)
FAULT_BLOCKS, FAULT_COHORT, FAULT_RETRIES = 10, 32, 2
FAULT_RATE, FAULT_ENVELOPE = 0.25, 0.10
CRASH_BLOCK, CHECKPOINT_EVERY = 6, 2
#: the small reference population (tests/test_obs.py's configuration)
REF_SPEC = dict(name="t_obs", m=240, d=10, n_min=8, n_max=20, clusters=3)


def cohort_kernel_case(K_, seed=0, drop=0.1, device="cuda"):
    """The SDCA kernel's inputs at the cohort path's shape: K_ clients of
    CROSS_DEVICE_1M packed to n_pad 64 (d 32, gram mode; rows past a
    client's n_t at mask 0), a warm-start alpha, one-pass budgets with a
    ``drop`` share of the slots at budget 0 (dropped clients), streams from
    the port's PRNG; ``kernel_case``'s layout."""
    from repro_torch.cohort import CROSS_DEVICE_1M, Population, pack_cohort
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    rng = np.random.default_rng(seed)
    ids = rng.choice(CROSS_DEVICE_1M.m, K_, replace=False)
    data = pack_cohort(Population(CROSS_DEVICE_1M), ids, device=device)
    m, n, d = data.X.shape
    dev = data.X.device

    def on(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    budgets = torch.round(data.n_t).to(torch.int32)
    budgets[torch.from_numpy(rng.random(m) < drop).to(dev)] = 0
    return dict(X=data.X, y=data.y, mask=data.mask,
                alpha=(data.y * data.mask
                       * on(rng.uniform(0, 1, (m, n)))).contiguous(),
                W=on(0.1 * rng.normal(size=(m, d))),
                q_t=on(rng.uniform(0.5, 2.0, m)), budgets=budgets,
                idx=draw_coordinates(prng.split(prng.PRNGKey(
                    seed, device=dev), m), data.n_t, n, n),
                max_steps=n, gram=None, xnorm2=data.xnorm2)


def _cohort_exp(pop, K_, engine, overlap, rounds=COHORT_BLOCKS, **ex):
    """The cohort_scale experiment at one (K, engine, overlap)."""
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem, \
        Systems
    from repro_torch.core import BudgetConfig, Probabilistic, SystemsConfig
    return Experiment(
        problem=Problem(population=pop),
        method=Method(loss="hinge", regularizers=(
            Probabilistic(lam=1e-2, sigma2=10.0),), rounds=rounds,
            budget=BudgetConfig(passes=1.0)),
        systems=Systems(config=SystemsConfig(network="lte", rate_lo=0.5,
                                             rate_hi=2.0),
                        sampler="weighted", dropout=0.1),
        exec=Exec(engine=engine, cohort=K_, clusters=pop.spec.clusters,
                  overlap=overlap, staleness=0, **ex),
        eval=Eval(record_every=1))


def _same_cohort_bits(label, a, b):
    if a.history != b.history or not all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for k in ("centroids", "omega_k", "assign", "participation")):
        raise AssertionError(f"{label}: the two runs' bits differ")


def cohort_scale(card):
    """(a) CROSS_DEVICE_1M at K 64 and 256, 8 blocks, overlap 1 and 4 at
    staleness 0, on the local engine (pre-sampled driver: one captured
    round program a run) and the kernel engine (one SDCA launch per block,
    counted); cold and warm walls, overlap 4 against overlap 1 bit for
    bit, the kernel engine's history against the local engine's."""
    from repro_torch.cohort import CROSS_DEVICE_1M, Population
    from repro_torch.core import RoundProgram
    pop = Population(CROSS_DEVICE_1M, seed=0)
    rows, launches = {}, 0
    for K_ in COHORT_KS:
        res = {}
        for engine in ("local", "kernel"):
            for overlap in (1, COHORT_OVERLAP):
                exp = _cohort_exp(pop, K_, engine, overlap)
                before = RoundProgram.captures
                reset_all_counts()
                cold, cold_s = _run_timed(exp)
                n_launch = read_counts()["sdca_local_solve"]
                captures = RoundProgram.captures - before
                want = (1, 0) if engine == "local" else (0, COHORT_BLOCKS)
                if (captures, n_launch) != want or \
                        cold.result.captures != want[0]:
                    raise AssertionError(
                        f"cohort K={K_} {engine} overlap {overlap}: "
                        f"{captures} captures, {n_launch} launches in "
                        f"{COHORT_BLOCKS} blocks (expected {want})")
                launches += n_launch
                # warm: the best of two more runs (each pre-samples its
                # schedule and, on the local engine, captures its program)
                warm, warm_s = min((_run_timed(exp) for _ in range(2)),
                                   key=lambda r: r[1])
                _same_cohort_bits(f"cohort K={K_} {engine} rerun",
                                  cold.result, warm.result)
                res[engine, overlap] = cold
                capture_s = warm.result.capture_s or 0.0
                row = dict(cold_wall_s=cold_s, warm_wall_s=warm_s,
                           warm_ms_per_block=1e3 * warm_s / COHORT_BLOCKS,
                           warm_ms_per_block_after_capture=1e3 * (
                               warm_s - capture_s) / COHORT_BLOCKS,
                           blocks_per_s=COHORT_BLOCKS / warm_s,
                           clients_per_s=K_ * COHORT_BLOCKS / warm_s,
                           captures=captures, launches=n_launch,
                           capture_s=cold.result.capture_s,
                           warm_capture_s=warm.result.capture_s,
                           final_primal=cold.final("primal"),
                           unique_clients=cold.final("unique_clients"))
                rows[f"K{K_}_{engine}_overlap{overlap}"] = row
                print(f"cohort (a) [cross_device_1m K={K_} {engine} "
                      f"overlap {overlap}, {COHORT_BLOCKS} blocks]: cold "
                      f"{cold_s:.3f} s (schedule pre-sampling"
                      + (f", capture {cold.result.capture_s:.3f} s" if
                         captures else "") + f"), warm "
                      f"{row['warm_ms_per_block']:.2f} ms/block"
                      + (f" ({row['warm_ms_per_block_after_capture']:.2f} "
                         "after the capture)" if captures else "")
                      + f", {row['blocks_per_s']:.1f} blocks/s, "
                      f"{row['clients_per_s']:.0f} clients/s, captures "
                      f"{captures}, SDCA launches {n_launch}, final primal "
                      f"{row['final_primal']:.6g}, unique clients "
                      f"{row['unique_clients']} [{card}]", flush=True)
            _same_cohort_bits(f"cohort K={K_} {engine} overlap "
                              f"{COHORT_OVERLAP} vs 1",
                              res[engine, 1].result,
                              res[engine, COHORT_OVERLAP].result)
        rel = _compare_histories(f"cohort K={K_} kernel vs local",
                                 res["kernel", 1].history,
                                 res["local", 1].history)
        rows[f"K{K_}_kernel_vs_local_rel"] = rel
        print(f"cohort (a) [K={K_}]: overlap {COHORT_OVERLAP} == overlap 1 "
              f"bit for bit on both engines; kernel vs local history max "
              f"rel diff {rel:.3e} of |primal| (tolerance "
              f"{HISTORY_RTOL:g})", flush=True)
    return rows, launches, pop


def cohort_faults(card):
    """(b) faults_scale: f = 0.25 with degradation inside the 10% envelope
    of the fault-free final primal; a run crashed at block 6 (checkpoints
    every 2 blocks) and resumed equals the uninterrupted run bit for bit."""
    import tempfile
    from repro_torch.cohort import (BlockFailure, FaultConfig, Population,
                                    PopulationSpec)
    pop = Population(PopulationSpec(**FAULT_SPEC), seed=0)

    def exp(**ex):
        faults = ex.pop("faults", None)
        e = _cohort_exp(pop, FAULT_COHORT, "local", 1, rounds=FAULT_BLOCKS,
                        **ex)
        return dataclasses.replace(e, systems=dataclasses.replace(
            e.systems, sampler="uniform", faults=faults))

    clean = exp()
    _run_timed(clean)
    ref, ref_s = _run_timed(clean)
    faults = FaultConfig(solve_fail_prob=FAULT_RATE,
                         pack_fail_prob=FAULT_RATE / 2,
                         fold_delay_prob=FAULT_RATE, fold_delay_s=2.0)
    faulty, faulty_s = _run_timed(exp(faults=faults,
                                      max_retries=FAULT_RETRIES,
                                      degrade=True))
    gap = (abs(faulty.final("primal") - ref.final("primal"))
           / max(abs(ref.final("primal")), 1.0))
    if gap > FAULT_ENVELOPE:
        raise AssertionError(f"faults: final primal drifted {gap:.3f} "
                             f"(> {FAULT_ENVELOPE}) from fault-free")
    with tempfile.TemporaryDirectory() as ckdir:
        kw = dict(checkpoint_every=CHECKPOINT_EVERY, checkpoint_dir=ckdir)
        t0 = time.perf_counter()
        try:
            exp(faults=FaultConfig(solve_fail_blocks=(CRASH_BLOCK,)),
                **kw).run(0)
            raise AssertionError("the hard fault did not crash the run")
        except BlockFailure:
            pass
        crash_s = time.perf_counter() - t0
        resumed, resume_s = _run_timed(exp(resume=True, **kw))
    _same_cohort_bits("faults: resumed vs uninterrupted", ref.result,
                      resumed.result)
    row = dict(clean_s=ref_s, faulty_s=faulty_s, convergence_gap=gap,
               retries=faulty.provenance["retries"],
               degraded_blocks=faulty.provenance["degraded_blocks"],
               crash_s=crash_s, resume_s=resume_s,
               resumed_from=resumed.result.resumed_from)
    print(f"cohort (b) faults [m={FAULT_SPEC['m']} K={FAULT_COHORT} "
          f"{FAULT_BLOCKS} blocks]: f={FAULT_RATE} with degradation: "
          f"final primal {faulty.final('primal'):.6g} vs fault-free "
          f"{ref.final('primal'):.6g} (gap {gap:.4f} <= {FAULT_ENVELOPE}), "
          f"{row['retries']} retries, {row['degraded_blocks']} degraded "
          f"blocks, {faulty_s:.3f} s (clean {ref_s:.3f} s); crash at block "
          f"{CRASH_BLOCK} + resume from block {row['resumed_from']} == "
          f"uninterrupted bit for bit ({crash_s:.3f} + {resume_s:.3f} s) "
          f"[{card}]", flush=True)
    return row


def cohort_reference():
    """(c) The small reference population on the card against the same run
    on the CPU (the parity contract), telemetry on; the Chrome trace
    validated."""
    import tempfile
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem, \
        Systems
    from repro_torch.cohort import Population, PopulationSpec
    from repro_torch.core import BudgetConfig, Probabilistic
    from repro_torch.obs import validate_chrome_trace
    reps = {}
    with tempfile.TemporaryDirectory() as tdir:
        for dev in ("cuda", "cpu"):
            reps[dev] = Experiment(
                problem=Problem(population=Population(
                    PopulationSpec(**REF_SPEC), seed=0)),
                method=Method(regularizers=(Probabilistic(
                    lam=1e-2, sigma2=10.0),), rounds=6,
                    omega_update_every=2, budget=BudgetConfig(passes=1.0)),
                systems=Systems(dropout=0.2),
                exec=Exec(cohort=12, clusters=3, overlap=2, device=dev,
                          trace_dir=f"{tdir}/{dev}"),
                eval=Eval(holdout_clients=20)).run(1)
        with open(reps["cuda"].provenance["trace_path"]) as fh:
            errors = validate_chrome_trace(json.load(fh))
    if errors:
        raise AssertionError(f"cohort trace: {errors[:3]}")
    card, cpu = reps["cuda"], reps["cpu"]
    if card.history["unique_clients"] != cpu.history["unique_clients"] or \
            card.history["time"] != cpu.history["time"]:
        raise AssertionError("cohort reference: coverage or clock differs")
    err = max(_close(f"cohort reference {k}", card.history[k],
                     cpu.history[k], OBJ_TOL)
              for k in ("dual", "primal", "gap"))
    werr = _close("cohort reference centroids", card.result.centroids,
                  cpu.result.centroids, W_TOL)
    tel = card.provenance["telemetry"]
    print(f"cohort (c) reference [m={REF_SPEC['m']} K=12, 6 blocks, overlap "
          f"2, telemetry on]: card vs cpu history max |diff| {err:.3e}, "
          f"centroids {werr:.3e}; trace valid, {tel['blocks_folded']} folds,"
          f" held-out error card {card.evaluation.summary['mean_error']:.4f}"
          f" cpu {cpu.evaluation.summary['mean_error']:.4f}", flush=True)
    return dict(history_err=err, centroid_err=werr)


def phase_cohort_path():
    """The cohort path, (a)-(c); the SDCA counter set to 0 just before each
    kernel-engine run and read just after it.  Also times the SDCA kernel at
    the cohort's K 256 shape beside its bound.  (d), the profile, is
    ``phase_cohort_profile``, run with the other profiles at the end."""
    from repro_torch.kernels import sdca as K
    t0 = time.perf_counter()
    card = card_line()
    rows, launches, _ = cohort_scale(card)
    faults = cohort_faults(card)
    ref = cohort_reference()
    case = cohort_kernel_case(256)
    kernel = lambda: K.sdca_local_solve(**case)   # noqa: E731
    plain = lambda: K.sdca_ref(**_plain_args(case))   # noqa: E731
    for _ in range(3):
        kernel()
    ms = _events_ms(kernel, 50)
    device_ms = _device_ms_per_call(lambda c: K.sdca_local_solve(**c),
                                    [case], PROFILE_CALLS, ("sdca_kernel",))
    plain()
    plain_ms = _events_ms(plain, 3)
    b = bound(case)
    timing = dict(shape="K=256 n_pad=64 d=32", mode=b["mode"], ms=ms,
                  device_ms=device_ms, plain_ms=plain_ms,
                  bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                  chain_steps=b["chain_steps"])
    wall = time.perf_counter() - t0
    print(f"cohort timing [SDCA at K=256 n_pad=64 d=32 {b['mode']}, 10% of "
          f"slots at budget 0]: kernel {ms:.4f} ms/call (device "
          f"{device_ms:.4f}), plain {plain_ms:.3f} ms/call, bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']}); cohort path "
          f"{wall:.1f} s [{card}]", flush=True)
    return dict(scale=rows, faults=faults, reference=ref, launches=launches,
                kernel=timing, wall_s=wall)


def _span_ms(tel):
    """{span name: (count, mean wall ms)} of a telemetry's spans."""
    durs = {}
    for buf in tel.tracer.spans().values():
        for sp in buf:
            if sp.dur_s is not None:
                durs.setdefault(sp.name, []).append(1e3 * sp.dur_s)
    return {k: (len(v), sum(v) / len(v)) for k, v in sorted(durs.items())}


def phase_cohort_profile():
    """(d) torch.profiler over two warm blocks (6 and 7 of 8) of the
    cohort_scale run at K 256 on each engine, stepped through the block
    loop's stages: device kernels and device time a block over the traced
    wall; then the run's own spans (telemetry on, host clock): the mean wall
    of pack, solve, fold and the driver's phases."""
    from torch.profiler import ProfilerActivity
    from repro_torch import obs
    from repro_torch.api import as_cohort_config
    from repro_torch.cohort import CROSS_DEVICE_1M, Population
    from repro_torch.cohort.driver import _BlockLoop, _run_cohort
    pop = Population(CROSS_DEVICE_1M, seed=0)
    out = {}
    for engine in ("local", "kernel"):
        exp = _cohort_exp(pop, 256, engine, 1)
        cfg = as_cohort_config(exp, seed=0)
        loop = _BlockLoop(pop, exp.method.regularizers[0], cfg)

        def blocks(lo, hi):
            for b in range(lo, hi):
                ids, dropped, alpha0, omega0 = loop.launch_args(b)
                packed = loop.pack_block(b)
                loop.fold(b, ids, packed.sizes, loop.solve_block(
                    b, packed, ids, dropped, alpha0, omega0))

        blocks(0, COHORT_BLOCKS - 2)
        wall, dev_ms, kernels = _traced(
            lambda: blocks(COHORT_BLOCKS - 2, COHORT_BLOCKS),
            [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        tel = obs.telemetry()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_cohort(pop, exp.method.regularizers[0],
                    dataclasses.replace(cfg, telemetry=True), telemetry=tel)
        torch.cuda.synchronize()
        spans = _span_ms(tel)
        row = dict(traced_ms_per_block=1e3 * wall / 2,
                   device_ms_per_block=dev_ms / 2, kernels_per_block=kernels
                   / 2, busy_traced=dev_ms / (1e3 * wall),
                   telemetry_wall_s=time.perf_counter() - t0, spans=spans)
        out[engine] = row
        print(f"profile [cohort K=256 {engine}, blocks 6-7]: "
              f"{row['kernels_per_block']:.0f} device kernels/block, device "
              f"busy {row['device_ms_per_block']:.3f} ms/block, traced wall "
              f"{row['traced_ms_per_block']:.2f} ms/block "
              f"({100 * row['busy_traced']:.1f}% busy); spans of a "
              f"{COHORT_BLOCKS}-block run (telemetry on, "
              f"{row['telemetry_wall_s']:.3f} s): " + ", ".join(
                  f"{k} x{n} {ms:.2f} ms" for k, (n, ms) in spans.items())
              + f" [{card_line()}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# The sharded runtime: tasks over the ranks of a process group
# ---------------------------------------------------------------------------

#: gloo ranks that share the one card in phase_sharded_path (d)
SHARD_RANKS = 2
#: the spawned ranks' wall limit, s: a rank that dies leaves the other in
#: a collective until the group's timeout; the phase fails before that
SHARD_TIMEOUT_S = 240
def wire_per_round(label, calls, rounds):
    """The collectives of one round, the same in every round: each
    gather's shape, dtype and bytes (its output, what every rank holds
    after it)."""
    per = len(calls) // rounds
    if per * rounds != len(calls) or calls != calls[:per] * rounds:
        raise AssertionError(f"{label}: {len(calls)} collectives in "
                             f"{rounds} rounds, not one pattern a round")
    if not all(c.name.startswith("all_gather") for c in calls[:per]):
        raise AssertionError(f"{label}: a round called "
                             f"{[c.name for c in calls[:per]]}")
    gathers = [dict(shape=list(c.shape),
                    dtype=str(c.dtype).removeprefix("torch."),
                    bytes=int(np.prod(c.shape)) * c.dtype.itemsize)
               for c in calls[:per]]
    return dict(collectives_per_round=per, gathers=gathers,
                bytes_per_round=sum(g["bytes"] for g in gathers))


def _sharded_exp(spec, reg, every, engine, device="cuda"):
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.data.synthetic import make_federation
    train, _ = make_federation(spec, seed=0, device=device)
    return Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=(reg,), rounds=ROUNDS,
                      omega_update_every=every),
        exec=Exec(engine=engine, driver="loop", device=device),
        eval=Eval(record_every=1))


def _same_run_bits(label, a, b):
    same = (a.history == b.history and np.array_equal(a.result.W, b.result.W)
            and np.array_equal(a.result.omega, b.result.omega)
            and all(x.device == y.device and torch.equal(x, y)
                    for x, y in zip(a.result.state, b.result.state)))
    if not same:
        raise AssertionError(f"{label}: the sharded run's bits differ from "
                             "the local engine's")


def _hold_run(label, got, want):
    """A run against the same run elsewhere (the run contract): the clock
    equal, dual and primal within OBJ_TOL.  The gap is their sum (each
    ~10^4 at full size, the gap ~10^2), so it is reported, not held.
    Returns the max |diff| of each."""
    if got["time"] != want["time"]:
        raise AssertionError(f"{label}: the clock differs")
    err = {k: _close(f"{label} {k}", got[k], want[k], OBJ_TOL)
           for k in ("dual", "primal")}
    err["gap"] = float(np.max(np.abs(np.asarray(got["gap"])
                                     - np.asarray(want["gap"]))))
    return err


@contextlib.contextmanager
def recorded_rounds():
    """Each sharded round's solve output u (this rank's Delta v block
    before the wire), and v before and after the round, copied where they
    lie."""
    import inspect
    from repro_torch.federated import runtime
    rounds, solve, round_ = [], runtime.batched_local_sdca, \
        runtime.distributed_round
    sig = inspect.signature(round_)

    def solve_rec(*args, **kwargs):
        dalpha, u = solve(*args, **kwargs)
        rounds[-1]["u"] = u.clone()
        return dalpha, u

    def round_rec(*args, **kwargs):
        a = sig.bind(*args, **kwargs).arguments
        rounds.append(dict(v=a["v"].clone(), gamma=a["gamma"]))
        alpha, v = round_(*args, **kwargs)
        rounds[-1]["v_out"] = v.clone()
        return alpha, v

    runtime.batched_local_sdca, runtime.distributed_round = (solve_rec,
                                                             round_rec)
    try:
        yield rounds
    finally:
        runtime.batched_local_sdca, runtime.distributed_round = (solve,
                                                                 round_)


def check_wire(label, rounds, wire):
    """Every round's wire held bit for bit on one rank: v after the round
    is v + gamma * (the CPU's ``wire`` image of the card's u), in v's
    dtype.  The two faults the check is there for, the cast skipped and v
    accumulated in the wire's dtype, are planted on the same inputs; each
    must miss it in some round (the second cannot show while v is 0).
    Returns, per planted fault, the rounds in which it was caught."""
    caught = {"cast skipped": 0, "v in the wire's dtype": 0}
    for i, r in enumerate(rounds):
        v, u, v_out, gamma = r["v"], r["u"], r["v_out"], r["gamma"]
        if u.shape != v.shape:
            raise AssertionError(f"{label}: one rank's block {u.shape}")
        image = u.cpu().to(wire).to(v.device)
        want = v + gamma * image.to(v.dtype)
        if v_out.dtype != v.dtype or not torch.equal(v_out, want):
            raise AssertionError(
                f"{label} round {i}: v is not v + gamma * the {wire} image "
                f"of u ({v_out.dtype}, max |diff| "
                f"{(v_out.float() - want).abs().max().item():.3e})")
        planted = {"cast skipped": v + gamma * u,
                   "v in the wire's dtype": (v.to(wire) + gamma * image
                                             ).to(v.dtype)}
        for fault, x in planted.items():
            caught[fault] += not torch.equal(x, want)
    if not rounds or min(caught.values()) == 0:
        raise AssertionError(f"{label}: the planted faults pass the check "
                             f"in {len(rounds)} rounds: caught {caught}")
    return caught


def sharded_rank(rank, store, out):
    """One of SHARD_RANKS gloo ranks on the one card (phase (d), spawned
    by ``chip_smoke.py --sharded-rank``): the Vehicle Sensor run on the
    sharded engine, its results written to ``out``."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.core import Clustered
    from repro_torch.data.synthetic import VEHICLE_SENSOR
    from repro_torch.utils.dist import counted_collectives
    rank = int(rank)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS,
                            timeout=timedelta(seconds=SHARD_TIMEOUT_S // 2))
    exp = _sharded_exp(VEHICLE_SENSOR, Clustered(lam=1.0, k=3), 5, "sharded")
    with counted_collectives() as calls:
        rep, wall = _run_timed(exp)
    wire = wire_per_round("gloo ranks", calls, ROUNDS)
    np.savez(f"{out}.{rank}.npz", W=rep.result.W,
             alpha=rep.result.state.alpha.cpu().numpy(),
             v=rep.result.state.v.cpu().numpy(),
             devices=np.array([str(t.device) for t in rep.result.state]),
             wall_s=wall, wire=json.dumps(wire),
             **{f"h_{k}": np.asarray(v) for k, v in rep.history.items()})
    dist.destroy_process_group()
    return 0


def sharded_ranks_on_the_card(local_vs):
    """(d) SHARD_RANKS gloo ranks on the one card (the installed gloo
    takes CUDA tensors in its all-gather): every rank's bits equal, the
    result the local engine's within the run contract."""
    import tempfile
    with tempfile.TemporaryDirectory() as tdir:
        logs = [open(f"{tdir}/log.{r}", "w+") for r in range(SHARD_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
             str(r), f"{tdir}/store", f"{tdir}/out"],
            stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(SHARD_RANKS)]
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, p in enumerate(procs):
            logs[r].seek(0)
            log = logs[r].read()
            logs[r].close()
            if p.returncode != 0:
                raise AssertionError(f"gloo rank {r} exited "
                                     f"{p.returncode}: {log[-3000:]}")
        ranks = [dict(np.load(f"{tdir}/out.{r}.npz"))
                 for r in range(SHARD_RANKS)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k != "wall_s" and not np.array_equal(r[k], v):
                raise AssertionError(f"gloo ranks: {k} differs by rank")
    got = ranks[0]
    if set(got["devices"]) != {"cuda:0"}:
        raise AssertionError(f"gloo ranks' state on {set(got['devices'])}")
    err = max(_hold_run("gloo ranks vs local", {
        k: got[f"h_{k}"].tolist() for k in ("dual", "primal", "gap", "time")},
        local_vs.history).values())
    werr = _close("gloo ranks vs local W", got["W"], local_vs.result.W,
                  W_TOL, max(1.0, float(np.abs(local_vs.result.W).max())))
    wall = [1e3 * float(r["wall_s"]) / ROUNDS for r in ranks]
    return dict(ranks=SHARD_RANKS, wall_ms_per_round=wall,
                history_err=err, W_err=werr, **json.loads(str(got["wire"])))


#: ``phase_sharded_path`` (e): SmolLM-360M's (arch, layers) on the 1 x 1
#: mesh, and the seconds the check may take
LM_1X1 = ("smollm-360m", 4)
LM_1X1_BUDGET_S = 30.0


def sharded_lm_one_rank():
    """(e) ``repro_torch.examples.sharded_lm``'s runs on a 1 x 1 mesh over
    the NCCL group of one rank that this phase made, in this process and
    without ``gloo_collectives`` (``sharded_lm.collectives_for`` enters
    nothing on NCCL): SmolLM-360M at LM_1X1's depth, one bf16 AdamW step
    with f32 masters at B 4 x 512 and a generate of B 2 x 128 + 4 in f32,
    each held against the same run on one device as the mesh runs are
    (``train_row``, ``generate_row``), the launch counters set to 0 just
    before the mesh runs and read just after.  A 1 x 1 mesh carries no
    real collective: this checks the wiring (the NCCL group under the
    mesh, DTensor's functional collectives as NCCL gives them, the runs
    and their checks), not a collective's result; four cards run the
    example under ``torch.distributed.run`` in a call of their own."""
    from repro_torch.examples import sharded_lm as S
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    if S.through_gloo(dev):
        raise AssertionError("the one-rank group carries CUDA tensors "
                             "through gloo")
    mesh = make_test_mesh(1, 1)
    dm = device_mesh(mesh, "cuda")
    cfg = S.mesh_cfg(*LM_1X1)
    bf16, f32 = torch.bfloat16, torch.float32
    one_t = S.mesh_train_run(cfg, bf16, 4, dev, mesh, steps=1)
    one_g = S.mesh_generate_run(cfg, 2, 128, f32, dev, mesh=mesh, new=4)
    reset_all_counts()
    with S.collectives_for(dev):
        got_t = S.mesh_train_run(cfg, bf16, 4, dev, mesh, dm, steps=1)
        got_g = S.mesh_generate_run(cfg, 2, 128, f32, dev, one_g["fed"],
                                    mesh, dm, new=4)
    counts = read_counts()
    launches = {k: counts[k] for k in ("flash_attention", "decode_attention")}
    rows = [S.train_row(cfg.name, cfg, bf16, 4, S.SEQ, one_t, got_t,
                        [None]),
            S.generate_row(cfg.name, cfg, f32, 2, 128, 4, one_g, got_g,
                           got_g.pop("logits"), [None])]
    wall = time.perf_counter() - t0
    for _, ok, line in rows:
        print(f"sharded (e) 1 x 1 NCCL mesh {line}", flush=True)
        if not ok:
            raise AssertionError(f"sharded (e): {line}")
    print(f"sharded (e) 1 x 1 NCCL mesh: gloo_collectives not entered, "
          f"launches {launches}, {wall:.2f} s (budget "
          f"{LM_1X1_BUDGET_S:.0f} s)", flush=True)
    if min(launches.values()) == 0 or wall > LM_1X1_BUDGET_S:
        raise AssertionError(f"sharded (e): launches {launches}, "
                             f"{wall:.1f} s")
    return dict(mesh="1x1", backend=torch.distributed.get_backend_config(),
                gloo_collectives=False,
                train=rows[0][0], generate=rows[1][0], launches=launches,
                wall_s=wall)


def phase_sharded_path():
    """The sharded runtime on the card (``Exec(engine="sharded")``, loop
    driver): (a) one NCCL rank at Vehicle Sensor and Human Activity, equal
    to the local engine bit for bit; (b) the bf16 wire at Vehicle Sensor,
    each round's wire bit for bit against the CPU's cast and the run
    against the same run on the CPU; (c) the cohort path with the sharded
    inner engine at cohort_ref's shape, equal to the local engine bit for
    bit; (d) two gloo ranks on the one card; (e) between (c) and (d), the
    sharded LM step on a 1 x 1 mesh over the NCCL group
    (``sharded_lm_one_rank``).  Collectives counted, the walls per round
    beside the local engine's."""
    import torch.distributed as dist
    from repro_torch.api import Exec, Experiment, Method, Problem, Systems
    from repro_torch.cohort import Population, PopulationSpec
    from repro_torch.core import (BudgetConfig, Clustered, MeanRegularized,
                                  Probabilistic, ShardedEngine)
    from repro_torch.data.synthetic import (HUMAN_ACTIVITY, VEHICLE_SENSOR,
                                            tiny_problem)
    from repro_torch.utils.dist import counted_collectives
    out = {"ranks": 1}
    # the first collective of the process creates the NCCL communicator
    t0 = time.perf_counter()
    Experiment(problem=Problem(train=tiny_problem(m=4, device="cuda")[0]),
               method=Method(rounds=1), exec=Exec(engine="sharded")).run(0)
    torch.cuda.synchronize()
    out["nccl_init_s"] = time.perf_counter() - t0
    backend = dist.get_backend_config()
    if "cuda:nccl" not in backend:
        raise AssertionError(f"the one-rank group's backends: {backend}")
    local = {}
    cases = [("vehicle_sensor", VEHICLE_SENSOR, Clustered(lam=1.0, k=3), 5),
             ("human_activity", HUMAN_ACTIVITY, MeanRegularized(), 0)]
    for label, spec, reg, every in cases:
        # sharded, local, sharded: both timed runs come after a warm one
        first = _sharded_exp(spec, reg, every, "sharded").run(seed=0)
        rep_l, wall_l = _run_timed(_sharded_exp(spec, reg, every, "local"))
        with counted_collectives() as calls:
            rep_s, wall_s = _run_timed(_sharded_exp(spec, reg, every,
                                                    "sharded"))
        _same_run_bits(f"sharded [{label}]", first, rep_l)
        _same_run_bits(f"sharded [{label}]", rep_s, rep_l)
        wire = wire_per_round(label, calls, ROUNDS)
        local[label] = rep_l
        out[label] = dict(m=spec.m, d=spec.d, wall_ms_per_round=[
            1e3 * wall_s / ROUNDS, 1e3 * wall_l / ROUNDS], **wire)
        print(f"sharded (a) [{label}] one NCCL rank, m={spec.m} d={spec.d}, "
              f"{ROUNDS} rounds: alpha, v, W, Omega and history equal to the "
              f"local engine bit for bit; {wire['collectives_per_round']} "
              f"gathers a round " + ", ".join(
                  f"{g['shape']} {g['dtype']} {g['bytes']} B"
                  for g in wire["gathers"])
              + f"; wall/round (loop driver) sharded "
              f"{1e3 * wall_s / ROUNDS:.2f} ms local "
              f"{1e3 * wall_l / ROUNDS:.2f} ms", flush=True)
        if label == "vehicle_sensor":
            f32 = rep_s
    # (b) the bf16 wire, on the card and on the CPU; the f32 wire beside it
    vs = cases[0]
    with counted_collectives() as calls, recorded_rounds() as rounds:
        card, wall_b = _run_timed(_sharded_exp(
            *vs[1:], ShardedEngine(comm_dtype=torch.bfloat16)))
    caught = check_wire("bf16 wire", rounds, torch.bfloat16)
    if len(rounds) != ROUNDS or rounds[0]["u"].device.type != "cuda":
        raise AssertionError(f"bf16 wire: {len(rounds)} rounds held on "
                             f"{rounds[0]['u'].device}")
    cpu = _sharded_exp(*vs[1:], ShardedEngine(comm_dtype=torch.bfloat16),
                       device="cpu").run(seed=0)
    cpu32 = _sharded_exp(*vs[1:], "sharded", device="cpu").run(seed=0)
    err = {"bf16": _hold_run("bf16 wire card vs cpu", card.history,
                             cpu.history),
           "f32": _hold_run("f32 wire card vs cpu", f32.history,
                            cpu32.history)}
    off = {k: abs(card.final(k) - f32.final(k)) / abs(f32.final("primal"))
           for k in ("gap", "primal")}
    wire = wire_per_round("bf16 wire", calls, ROUNDS)
    out["bf16_wire"] = dict(wall_ms_per_round=1e3 * wall_b / ROUNDS,
                            rounds_held_bitwise=ROUNDS,
                            planted_faults_caught=caught,
                            card_vs_cpu_err=err, vs_f32_rel=off,
                            final_gap=[card.final("gap"), f32.final("gap")],
                            **wire)
    print(f"sharded (b) [vehicle_sensor] bf16 wire: each of {ROUNDS} "
          f"rounds' v equal to v + gamma * the CPU's bf16 image of the "
          f"card's u, bit for bit; planted on the same inputs, caught in "
          + ", ".join(f"{n}/{ROUNDS} rounds: {f}" for f, n in caught.items())
          + "; card vs cpu max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err["bf16"].items())
          + " (f32 wire: " + ", ".join(f"{k} {v:.3e}"
                                       for k, v in err["f32"].items())
          + f"); final gap bf16 {card.final('gap'):.6g} f32 "
          f"{f32.final('gap'):.6g}, |bf16 - f32| / |primal|: gap "
          f"{off['gap']:.3e} primal {off['primal']:.3e}; gathers "
          + ", ".join(f"{g['shape']} {g['dtype']} {g['bytes']} B"
                      for g in wire["gathers"])
          + f"; wall/round {1e3 * wall_b / ROUNDS:.2f} ms", flush=True)
    # (c) the cohort path, its K-task cohort sharded
    pop = Population(PopulationSpec(**REF_SPEC), seed=0)
    cohort = {}
    for engine in ("local", "sharded"):
        exp = Experiment(
            problem=Problem(population=pop),
            method=Method(regularizers=(Probabilistic(lam=1e-2,
                                                      sigma2=10.0),),
                          rounds=6, omega_update_every=2,
                          budget=BudgetConfig(passes=1.0)),
            systems=Systems(dropout=0.2),
            exec=Exec(engine=engine, cohort=12, clusters=3))
        with counted_collectives() as calls:
            cohort[engine] = _run_timed(exp) + (list(calls),)
    (rep_l, wall_l, _), (rep_s, wall_s, calls) = (cohort["local"],
                                                   cohort["sharded"])
    if rep_s.provenance["path"] != "cohort" or \
            rep_s.provenance["engine"] != "sharded":
        raise AssertionError(f"cohort: routed {rep_s.provenance['path']}")
    _same_cohort_bits("sharded cohort", rep_s.result, rep_l.result)
    wire = wire_per_round("cohort", calls, 6)
    out["cohort_ref"] = dict(blocks=6, wall_s=[wall_s, wall_l], **wire)
    print(f"sharded (c) [cohort_ref m={REF_SPEC['m']} K=12, 6 blocks] inner "
          f"engine sharded: history, centroids, Omega, assignments equal to "
          f"the local engine's bit for bit; {len(calls)} gathers "
          f"({wire['bytes_per_round']} B a block); wall sharded "
          f"{wall_s:.3f} s local (pre-sampled) {wall_l:.3f} s", flush=True)
    # (e) the sharded LM step's wiring on the same NCCL group
    out["lm_1x1"] = sharded_lm_one_rank()
    dist.destroy_process_group()
    # (d) two gloo ranks on the one card
    out["gloo_ranks"] = sharded_ranks_on_the_card(local["vehicle_sensor"])
    g = out["gloo_ranks"]
    print(f"sharded (d) [vehicle_sensor] {SHARD_RANKS} gloo ranks on the one "
          f"card (m 23 padded to 24): ranks equal bit for bit, history vs "
          f"local max |diff| {g['history_err']:.3e}, W {g['W_err']:.3e}; "
          f"gathers " + ", ".join(f"{x['shape']} {x['dtype']} {x['bytes']} B"
                                  for x in g["gathers"])
          + "; wall/round " + ", ".join(f"{w:.2f}" for w in
                                        g["wall_ms_per_round"])
          + f" ms [{card_line()}]", flush=True)
    return out


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(case):
    """The least time the card could take for one call: bytes moved once
    over HBM bandwidth, or fp32 operations over the fp32 peak, whichever is
    larger; operations counted for this input's live chunks."""
    from repro_torch.core.subproblem import _solver_plan
    X, budgets = case["X"], case["budgets"]
    m, n, d = X.shape
    steps = case["max_steps"]
    gram, C = _solver_plan(d, steps, case["gram"])
    n_chunks = -(-steps // C)
    nbytes = 4 * (m * n * d + 4 * m * n + m * d + m * n_chunks * C + 2 * m
                  + m * n + m * d)
    live = torch.clamp(budgets.to(torch.int64), max=steps).add(C - 1) // C
    if gram:   # G_c, p_c, C steps of O(C), column sum, r and u updates
        per_chunk = 2 * C * C * d + 2 * C * d + C * (2 * C + 12) + 2 * C * d \
            + 3 * d
    else:      # C steps of dot + axpy, column sum, u update
        per_chunk = C * (4 * d + 12) + 2 * C * d + d
    flops = int(live.sum()) * per_chunk
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    chain = int(live.max()) * C
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, chain_steps=chain,
                mode="gram" if gram else "carry")


def max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def chain_floor(mode, d, chain_steps, mhz):
    """A model, not a measurement: chain steps x one dependent step of the
    SDCA kernel's chain (csrc/sdca.cu) as counted from its instructions, at
    assumed Hopper latencies (4 cycles an FP32 add, multiply, FMA, min or
    max; 23 a shuffle; 46 a shared-memory store and the load of it) and the
    card's highest SM clock.  Returns (cycles per step, ms).

    Gram: acc += G_ks delta_s, q acc, p + ., y g, 1 - ., the numerator's
    clamp (2), the division's multiply and two FMAs, abar + step clamped
    (one saturating add), - abar, * y, * live: 14 FP32, then the shuffle
    that hands delta on.  Carry: NR / 3 FMAs per accumulator (NR the r
    registers a lane, three accumulators), two adds, the warp sum (a store,
    a load, five levels of adds), the same hinge update from y g on, q
    delta, qd x, r + .: 21 + NR / 3 FP32 and one round trip."""
    if mode == "gram":
        cycles = 14 * 4 + 23
    else:
        nr = -(-d // 32)
        nr = -(-nr // 3) * 3   # the kernel's carry_nr(d)
        cycles = (21 + nr // 3) * 4 + 46
    return cycles, chain_steps * cycles / (mhz * 1e3)


def phase_timing(main, errs):
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    from repro_torch.kernels import sdca as K
    card = card_line()
    mhz = max_sm_mhz()
    shapes = {}
    for label, spec, err in (("vehicle_sensor", VEHICLE_SENSOR, errs["gram"]),
                             ("human_activity", HUMAN_ACTIVITY,
                              errs["carry"])):
        case = kernel_case(spec)
        kernel = lambda: K.sdca_local_solve(**case)   # noqa: E731
        plain = lambda: K.sdca_ref(**_plain_args(case))   # noqa: E731
        for _ in range(3):
            kernel()
        ms = _events_ms(kernel, 50)
        device_ms = _device_ms_per_call(lambda c: K.sdca_local_solve(**c),
                                        [case], PROFILE_CALLS,
                                        ("sdca_kernel",))
        plain()
        plain_ms = _events_ms(plain, 3)
        b = bound(case)
        m, n, d = case["X"].shape
        step_cycles, floor_ms = chain_floor(b["mode"], d, b["chain_steps"],
                                            mhz)
        row = dict(shape=f"m={m} n={n} d={d}", mode=b["mode"], ms=ms,
                   device_ms=device_ms,
                   plain_ms=plain_ms, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], bytes=b["bytes"],
                   flops=b["flops"], chain_steps=b["chain_steps"],
                   ns_per_chain_step=1e6 * ms / b["chain_steps"],
                   max_abs_err=err, wall_ms_per_round_kernel=main[label][
                       "wall_ms"][0],
                   wall_ms_per_round_local=main[label]["wall_ms"][1])
        # the engines once more, in the other order (local, then kernel)
        for i, key in ((1, "exp_l"), (0, "exp_k")):
            _, wall = _run_timed(main[label][key])
            row.setdefault("wall_ms_per_round_repeat", [None, None])[i] = (
                1e3 * wall / ROUNDS)
        shapes[label] = row
        print(f"timing [{label}] {row['shape']} {row['mode']}: kernel "
              f"{ms:.4f} ms/call (device {device_ms:.4f}), plain "
              f"{plain_ms:.2f} ms/call, bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}), chain "
              f"{b['chain_steps']} steps -> {row['ns_per_chain_step']:.1f} "
              f"ns/step, chain floor (modelled) {floor_ms:.4f} ms "
              f"({step_cycles} cycles/step at {mhz:.0f} MHz, "
              f"{1e3 * step_cycles / mhz:.1f} ns); wall/round (loop "
              f"driver) kernel engine "
              f"{row['wall_ms_per_round_kernel']:.2f} / "
              f"{row['wall_ms_per_round_repeat'][0]:.2f} ms, local engine "
              f"{row['wall_ms_per_round_local']:.2f} / "
              f"{row['wall_ms_per_round_repeat'][1]:.2f} ms [{card}]",
              flush=True)
    return shapes


def phase_profile(main_runs):
    """Where a kernel-engine round's time goes: ``torch.profiler`` over a
    3-round Vehicle Sensor run (after the runs above warmed it up)."""
    from torch.profiler import ProfilerActivity, profile
    exp = dataclasses.replace(
        main_runs["vehicle_sensor"]["exp_k"],
        method=dataclasses.replace(
            main_runs["vehicle_sensor"]["exp_k"].method, rounds=3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _run_timed(exp)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total",
                                                0))[:6]
    print(f"profile [vehicle_sensor kernel engine, 3 rounds]: wall "
          f"{1e3 * wall / 3:.2f} ms/round, device busy "
          f"{dev_us / 3e3:.3f} ms/round ({100 * dev_us / 1e6 / wall:.1f}% "
          f"of wall), {launches / 3:.0f} device kernels/round; top by device "
          f"time: " + "; ".join(
              f"{e.key[:60]} x{e.count} "
              f"{getattr(e, 'self_device_time_total', 0) / 3e3:.3f} ms/round"
              for e in top), flush=True)


# ---------------------------------------------------------------------------
# LM serving: the flash and decode attention kernels
# ---------------------------------------------------------------------------

#: kernel vs plain version, element by element: the rule of
#: ``repro_torch/kernels/flash_attention/ref.py`` (``attention_tolerance``,
#: and ``flash_tolerance`` for flash, whose bf16 kernel rounds P to bf16)
#: the main path: SmolLM-360M at full width, random weights from seed 0
ARCH, SEED = "smollm-360m", 0
BATCH, PROMPT, NEW = 8, 1024, 32
MAX_LEN = PROMPT + NEW + 8          # as launch/serve.py sizes the cache
#: kernel route vs plain route on the card, logits relative to
#: max(1, max |plain logit|): 32 layers of the per-layer rounding above
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
PEAK_BF16 = 989e12                  # tensor-core dense bf16, FLOP/s
PEAK_OPS = {torch.float32: PEAK_FP32, torch.bfloat16: PEAK_BF16}
DEV = "cuda"


def reset_all_counts():
    from repro_torch.kernels import cache_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import sdca as K
    for mod in (K, FA, DA, CA):
        mod.reset_counts()


def read_counts():
    from repro_torch.kernels import cache_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import sdca as K
    return {**K.COUNTS, **FA.COUNTS, **DA.COUNTS, **CA.COUNTS}


def _normal(shape, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def flash_case(b, s, h, hkv, d, dtype=torch.float32, causal=True,
               window=None, seed=0):
    return dict(q=_normal((b, s, h, d), dtype, seed),
                k=_normal((b, s, hkv, d), dtype, seed + 1),
                v=_normal((b, s, hkv, d), dtype, seed + 2),
                causal=causal, window=window)


def decode_case(b, t, h, hkv, d, lengths, dtype=torch.float32, seed=0):
    return dict(q=_normal((b, 1, h, d), dtype, seed),
                k=_normal((b, t, hkv, d), dtype, seed + 1),
                v=_normal((b, t, hkv, d), dtype, seed + 2),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=DEV))


def cache_case(b, s, t, h, hkv, d, dtype=torch.float32, window=None,
               seed=0):
    """Cache attention inputs as a segment into a used cache makes them:
    row r's slots hold a shuffle of positions r .. r + T - 1, the last
    T / 16 of them unwritten (-1); its S queries the positions up to the
    cache's last written one.  Row 0's queries lie before every position
    the cache holds: each reads the mean of V over the T slots."""
    rng = np.random.default_rng(seed)
    k_pos = np.stack([rng.permutation(t) + r for r in range(b)])
    k_pos[:, t - t // 16:] = -1
    top = k_pos.max(1, keepdims=True)
    q_pos = top - s + 1 + np.arange(s)[None]
    q_pos[0] = np.arange(s) - s - 1
    on = lambda a: torch.from_numpy(a.astype(np.int32)).to(DEV)  # noqa
    return dict(q=_normal((b, s, h, d), dtype, seed),
                k=_normal((b, t, hkv, d), dtype, seed + 1),
                v=_normal((b, t, hkv, d), dtype, seed + 2),
                q_pos=on(q_pos), k_pos=on(k_pos), window=window)


def _attn_plain(name, case):
    from repro_torch.kernels.cache_attention import cache_attention_ref
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_ref
    if name == "flash":
        return attention_ref(**case)
    if name == "cache":
        return cache_attention_ref(**case)
    return decode_attention_ref(case["q"][:, 0], case["k"], case["v"],
                                case["lengths"])[:, None]


def _attn_kernel(name, case):
    from repro_torch.kernels.cache_attention import cache_mha
    from repro_torch.kernels.decode_attention import decode_mha
    from repro_torch.kernels.flash_attention import flash_mha
    if name == "cache":
        return cache_mha(**case)
    return flash_mha(**case) if name == "flash" else decode_mha(**case)


@contextlib.contextmanager
def plain_attention():
    """The plain versions in place of the kernels in the model's layers, for
    the route comparison only (the port itself never falls back)."""
    from repro_torch.models import layers
    saved = layers.flash_mha, layers.decode_mha, layers.cache_mha

    def cache(q, k, v, q_pos, k_pos, window=None, return_lse=False):
        from repro_torch.kernels.cache_attention import cache_attention_ref
        return cache_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                   return_lse=return_lse)

    def flash(q, k, v, causal=True, window=None):
        return _attn_plain("flash", dict(q=q, k=k, v=v, causal=causal,
                                         window=window))

    def decode(q, k, v, lengths, return_lse=False):
        from repro_torch.kernels.decode_attention import decode_attention_ref
        if return_lse:
            out, lse = decode_attention_ref(q[:, 0], k, v, lengths,
                                            return_lse=True)
            return out[:, None], lse
        return _attn_plain("decode", dict(q=q, k=k, v=v, lengths=lengths))

    layers.flash_mha, layers.decode_mha, layers.cache_mha = (flash, decode,
                                                             cache)
    try:
        yield
    finally:
        layers.flash_mha, layers.decode_mha, layers.cache_mha = saved


def _route(name):
    return plain_attention() if name == "plain" else contextlib.nullcontext()


def _tolerance(name, case, plain):
    from repro_torch.kernels.cache_attention import cache_tolerance
    from repro_torch.kernels.flash_attention import (attention_tolerance,
                                                     flash_tolerance)
    if name == "flash":
        return flash_tolerance(case["q"], case["k"], case["v"], plain,
                               causal=case["causal"], window=case["window"])
    if name == "cache":
        return cache_tolerance(case["q"], case["k"], case["v"],
                               case["q_pos"], case["k_pos"], plain,
                               case["window"])
    return attention_tolerance(plain)


def _rule(name, dtype, d):
    rule = "2e-5 x max(1, max|plain|)"
    if dtype == torch.bfloat16:
        rule = "1e-2 x |plain| + " + rule
        if design(name, dtype, d) == "wgmma+tma":
            rule += " + 2^-7 x attn(|v|)"
    return rule


def check_attention(name, label, case, plain=None):
    out = _attn_kernel(name, case)
    ref = _attn_plain(name, case) if plain is None else plain
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} kernel output not finite: {label}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    share = float((diff / _tolerance(name, case, ref)).max())
    ok = out.dtype == ref.dtype and share <= 1.0
    d = case["q"].shape[-1]
    kind = design(name, case["q"].dtype, d)
    print(f"{name} kernel ({kind}) vs plain [{label}]: max_abs_err="
          f"{err:.3e}, largest "
          f"share of the tolerance {_rule(name, ref.dtype, d)}: {share:.3f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with plain version: "
                             f"{label}")
    return err


def one_hot_case(d, b=2, s=192, h=4, hkv=2):
    """bf16 flash inputs whose every query row scores one key (a
    permutation of the rows) far above the rest, and the output that
    implies, that key's v row: P is one-hot, so a probability that reaches
    the wrong key shows as an error of order |v|."""
    k = _normal((b, s, hkv, d), torch.float32, 1)
    v = _normal((b, s, hkv, d), torch.float32, 2)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(s)).to(DEV)
    q = 8.0 * k[:, perm].repeat_interleave(h // hkv, dim=2)
    bf = torch.bfloat16
    case = dict(q=q.to(bf).contiguous(), k=k.to(bf), v=v.to(bf),
                causal=False, window=None)
    return case, case["v"][:, perm].repeat_interleave(h // hkv, dim=2)


def phase_attention_kernels():
    """Flash and decode against their plain versions on the card: the cases
    of tests/test_kernels.py, a ragged S and T, and the main path's shapes
    (SmolLM-360M: H 15, Hkv 5, D 64; B 8, S 1024, T 1064)."""
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {(name, dt): 0.0 for name in ("flash", "decode")
            for dt in (f32, bf16)}

    def run(name, label, case, plain=None):
        key = (name, case["q"].dtype)
        errs[key] = max(errs[key], check_attention(name, label, case, plain))

    for b, h, s, d in ((1, 1, 128, 32), (2, 3, 256, 64), (1, 2, 512, 128),
                       (1, 1, 128, 256)):
        run("flash", f"causal b{b} h{h} s{s} d{d}",
            flash_case(b, s, h, h, d))
    for w in (32, 64, 128):
        run("flash", f"window {w}", flash_case(1, 256, 2, 2, 64, window=w))
    run("flash", "non-causal", flash_case(1, 128, 1, 1, 64, causal=False))
    run("flash", "bf16", flash_case(1, 128, 2, 2, 64, bf16))
    run("flash", "GQA 4/2", flash_case(1, 128, 4, 2, 64))
    run("flash", "ragged S 1000, GQA 6/2, d128, bf16",
        flash_case(1, 1000, 6, 2, 128, bf16))
    run("flash", "ragged S 77, non-causal window 16",
        flash_case(1, 77, 2, 1, 64, causal=False, window=16))
    # the f32 CUDA-core kernel at every head_dim: S not a multiple of its
    # query or key tiles, windows, GQA, non-causal
    for d in (32, 64, 128, 256):
        run("flash", f"f32 d{d} ragged S 333 GQA 6/2 window 100",
            flash_case(2, 333, 6, 2, d, window=100))
        run("flash", f"f32 d{d} ragged S 257 GQA 4/1 non-causal",
            flash_case(1, 257, 4, 1, d, causal=False))
    for dt in (f32, bf16):
        run("flash", f"main path B8 S1024 H15/5 D64 {str(dt)[6:]}",
            flash_case(BATCH, PROMPT, 15, 5, 64, dt))
    # the bf16 tensor-core kernel at head_dim 128 and 256 (starcoder2-15b,
    # gemma-2b), ragged S, windows, non-causal, and one-hot P at all three
    run("flash", "bf16 d128 B2 S1024 H8/2", flash_case(2, 1024, 8, 2, 128,
                                                       bf16))
    run("flash", "bf16 d256 ragged S 1000 H8/1", flash_case(1, 1000, 8, 1,
                                                            256, bf16))
    run("flash", "bf16 d128 window 200", flash_case(1, 384, 2, 2, 128, bf16,
                                                    window=200))
    run("flash", "bf16 d256 non-causal window 64",
        flash_case(1, 384, 2, 1, 256, bf16, causal=False, window=64))
    run("flash", "bf16 d64 ragged S 77", flash_case(1, 77, 2, 1, 64, bf16))
    for d in (64, 112, 128, 256):
        case, want = one_hot_case(d)
        got = _attn_kernel("flash", case)
        err = float((got.float() - want.float()).abs().max())
        if not err <= 2e-2 * max(1.0, float(want.float().abs().max())):
            raise AssertionError(f"flash bf16 d{d}: one-hot P output is not "
                                 f"the chosen key's v row ({err:.3e})")
        run("flash", f"bf16 d{d} one-hot P (vs chosen v: {err:.2e})", case)

    rng = np.random.default_rng(0)
    for b, h, t, d in ((2, 2, 256, 64), (1, 4, 1024, 128), (3, 1, 512, 32),
                       (1, 8, 2048, 64)):
        run("decode", f"b{b} h{h} t{t} d{d}",
            decode_case(b, t, h, h, d, rng.integers(1, t, b).tolist()))
    run("decode", "bf16", decode_case(2, 256, 2, 2, 64, [200, 64], bf16))
    run("decode", "GQA 4/2, lengths T and T/2",
        decode_case(2, 256, 4, 2, 64, [256, 128]))
    lens = [1, MAX_LEN, *rng.integers(PROMPT, MAX_LEN, BATCH - 2).tolist()]
    for dt in (f32, bf16):
        run("decode", f"main path B8 T1064 H15/5 D64 lengths 1..T "
            f"{str(dt)[6:]}", decode_case(BATCH, MAX_LEN, 15, 5, 64, lens,
                                          dt))
    # lengths at chunk boundaries of the split (T 1064 is not a multiple of
    # the chunk), against the plain version and the plain split-and-merge
    from repro_torch.kernels.decode_attention import (
        decode_attention_split_ref, split_plan)
    chunk = split_plan(MAX_LEN, BATCH, 5, torch.cuda.get_device_properties(
        0).multi_processor_count)
    edges = [min(n, MAX_LEN) for n in (1, 63, 64, 65, 128, MAX_LEN,
                                       chunk + 1, MAX_LEN - 1)][:BATCH]
    for dt in (f32, bf16):
        case = decode_case(BATCH, MAX_LEN, 15, 5, 64, edges, dt)
        run("decode", f"split chunk {chunk}, lengths {edges} "
            f"{str(dt)[6:]}", case)
        run("decode", f"split chunk {chunk} vs plain split+merge "
            f"{str(dt)[6:]}", case, decode_attention_split_ref(
                case["q"][:, 0], case["k"], case["v"], case["lengths"],
                chunk)[:, None])
    # head_dim 112 (zamba2-7b's shared attention, 32/32 heads): flash on
    # the CUDA cores in f32 and on the tensor cores in bf16, ragged S,
    # causal, with and without a window, GQA, and in bf16 one head (a store
    # past column 112 would land on the next row); decode over ragged
    # lengths
    run("flash", "d112 ragged S 333 H4/4 non-causal window 16 bfloat16",
        flash_case(1, 333, 4, 4, 112, bf16, causal=False, window=16))
    run("flash", "d112 B2 S300 H1/1 bfloat16", flash_case(2, 300, 1, 1, 112,
                                                           bf16))
    for dt in (f32, bf16):
        n = str(dt)[6:]
        run("flash", f"d112 ragged S 333 H4/4 causal {n}",
            flash_case(2, 333, 4, 4, 112, dt))
        run("flash", f"d112 ragged S 300 GQA 6/2 window 100 {n}",
            flash_case(1, 300, 6, 2, 112, dt, window=100))
        run("flash", f"d112 ragged S 77 non-causal window 16 {n}",
            flash_case(1, 77, 2, 1, 112, dt, causal=False, window=16))
        run("flash", f"d112 zamba2 B2 S256 H32/32 {n}",
            flash_case(2, 256, 32, 32, 112, dt))
        run("decode", f"d112 zamba2 B2 T280 H32/32 lengths 1, 271 {n}",
            decode_case(2, 280, 32, 32, 112, [1, 271], dt))
        run("decode", f"d112 B3 T1000 GQA 8/2 ragged lengths {n}",
            decode_case(3, 1000, 8, 2, 112, [999, 64, 513], dt))
    check_decode_masking(lens)
    errs[("decode_lse", f32)] = check_decode_lse()
    # cache attention at the segments' shapes: SmolLM-360M's 256-token
    # segment over its 1,064-slot cache (no split), zamba2-7b's 64 tokens
    # over 328 slots at head_dim 112 (split over the slots), mixtral-8x7b's
    # window; row 0 all masked in each
    for dt in (f32, bf16):
        n = str(dt)[6:]
        errs[("cache", dt)] = 0.0
        for label, case in (
                ("SmolLM B8 S256 T1064 H15/5 D64",
                 cache_case(BATCH, 256, MAX_LEN, 15, 5, 64, dt)),
                ("SmolLM window 300", cache_case(BATCH, 256, MAX_LEN, 15,
                                                 5, 64, dt, window=300)),
                ("zamba2 B2 S64 T328 H32/32 D112",
                 cache_case(2, 64, 328, 32, 32, 112, dt)),
                ("mixtral-like B1 S200 T4096 H32/8 D128 window 4096",
                 cache_case(1, 200, 4096, 32, 8, 128, dt, window=4096)),
                ("ragged B3 S37 T77 H6/2 D32", cache_case(3, 37, 77, 6, 2,
                                                          32, dt)),
                ("one query B2 S1 T1000 H8/2 D256",
                 cache_case(2, 1, 1000, 8, 2, 256, dt))):
            errs[("cache", dt)] = max(errs[("cache", dt)], check_attention(
                "cache", f"{label} {n}, row 0 all masked", case))
    errs[("cache_lse", f32)] = check_cache_lse()
    return errs


def check_cache_lse():
    """The cache kernel's log-sum-exp output (``return_lse``, what the
    mesh's merge weighs the slices by) against the plain version's, f32
    and bf16, with and without the split: within 2e-5 x max(1, |lse|),
    -inf exactly on the all-masked rows, the output bitwise the one
    without ``return_lse``.  Returns the largest share of the
    tolerance."""
    from repro_torch.kernels.cache_attention import (cache_attention,
                                                     cache_attention_ref)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for shape in ((BATCH, 256, MAX_LEN, 15, 5, 64),
                      (2, 64, 328, 32, 32, 112)):
            c = cache_case(*shape, dt)
            args = (c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"])
            out, lse = cache_attention(*args, return_lse=True)
            out0 = cache_attention(*args)
            _, want = cache_attention_ref(*args, return_lse=True)
            torch.cuda.synchronize()
            dead = torch.isneginf(want)
            share = float(((lse[~dead] - want[~dead]).abs()
                           / (2e-5 * want[~dead].abs().clamp_min(1.0)))
                          .max())
            ok = (torch.equal(torch.isneginf(lse), dead) and share <= 1.0
                  and torch.equal(out, out0) and bool(dead[0].all()))
            worst = max(worst, share)
            print(f"cache kernel lse vs plain [{str(dt)[6:]} {shape}]: "
                  f"largest share of 2e-5 x max(1, |lse|) {share:.3f}, -inf "
                  f"rows {int(dead.sum())}, output bitwise unchanged "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"cache lse {dt} {shape}")
    return worst


def check_decode_masking(lens):
    """Slots at or past lengths have exactly no influence on the kernel."""
    case = decode_case(BATCH, MAX_LEN, 15, 5, 64, lens)
    out1 = _attn_kernel("decode", case)
    for i, n in enumerate(lens):
        case["k"][i, n:] = 999.0
        case["v"][i, n:] = float("nan")
    out2 = _attn_kernel("decode", case)
    torch.cuda.synchronize()
    if not torch.equal(out1, out2):
        raise AssertionError("decode kernel reads slots past lengths")
    print("decode kernel [garbage past lengths]: output bitwise unchanged "
          "ok", flush=True)


def check_decode_lse():
    """The decode kernel's log-sum-exp output (``return_lse``, what the
    mesh's sequence-sharded decode merges by) against the plain split and
    merge's, f32 and bf16 at head_dim 64, 112 and 128, lengths 0 included:
    within 2e-5 x max(1, |lse|), -inf exactly where a row has no live slot;
    the output bitwise the one without ``return_lse``.  Returns the largest
    share of the tolerance."""
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_split_ref, split_plan)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for d in (64, 112, 128):
            b, t, h, hkv = 6, 600, 8, 2
            case = decode_case(b, t, h, hkv, d, [0, 1, 63, 300, 599, 600],
                               dt)
            q, k, v, lens = (case["q"][:, 0], case["k"], case["v"],
                             case["lengths"])
            out, lse = decode_attention(q, k, v, lens, return_lse=True)
            out0 = decode_attention(q, k, v, lens)
            chunk = split_plan(t, b, hkv, torch.cuda.get_device_properties(
                0).multi_processor_count)
            _, want = decode_attention_split_ref(q, k, v, lens, chunk,
                                                 return_lse=True)
            torch.cuda.synchronize()
            dead = torch.isneginf(want)
            share = float(((lse[~dead] - want[~dead]).abs()
                           / (2e-5 * want[~dead].abs().clamp_min(1.0)))
                          .max())
            ok = (torch.equal(torch.isneginf(lse), dead) and share <= 1.0
                  and torch.equal(out, out0) and not out[0].any())
            worst = max(worst, share)
            print(f"decode kernel lse vs plain [{str(dt)[6:]} d{d}, "
                  f"lengths 0..T]: largest share of 2e-5 x max(1, |lse|) "
                  f"{share:.3f}, -inf rows {int(dead.sum())}, output bitwise "
                  f"unchanged {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"decode lse {dt} d{d}")
    return worst


def _lm_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(get_config(ARCH), device=DEV, seed=SEED)


def _prompt(vocab):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, vocab, (BATCH, PROMPT))).to(DEV)


def _generate(model, tokens, dtype):
    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(model, ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                                    cache_dtype=dtype))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, logits = eng.generate({"tokens": tokens}, return_logits=True)
    torch.cuda.synchronize()
    return out, logits, time.perf_counter() - t0


def _forced_logits(model, tokens, forced, dtype):
    """The logits of ``Engine.generate`` (prefill, then NEW - 1 decode
    steps) with the decode steps fed the tokens ``forced`` (B, NEW) instead
    of their own greedy choices."""
    cache = model.init_cache(BATCH, MAX_LEN, dtype=dtype)
    logits, cache = model.prefill({"tokens": tokens}, cache, dtype=dtype)
    seen = [logits]
    for i in range(NEW - 1):
        tok = torch.from_numpy(np.ascontiguousarray(forced[:, i])).to(
            DEV, torch.int32)
        logits, cache = model.decode_step(tok, cache, dtype=dtype)
        seen.append(logits)
    return torch.stack(seen, dim=1)


def phase_lm_main_path():
    """The LM main path: SmolLM-360M at full width through Engine.generate,
    the kernel route with the launch counters set to 0 just before each
    generate and read just after, then the plain route on the card."""
    model = _lm_model()
    cfg = model.cfg
    tokens = _prompt(cfg.vocab_size)
    out = {"model": model, "tokens": tokens}
    for dtype in (torch.float32, torch.bfloat16):
        reset_all_counts()
        tok_k, lg_k, wall_k = _generate(model, tokens, dtype)
        counts = read_counts()
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * (NEW - 1),
                "sdca_local_solve": 0, "cache_attention": 0}
        if counts != want:
            raise AssertionError(f"LM main path launches {counts}, expected "
                                 f"{want}")
        reset_all_counts()
        with plain_attention():
            tok_p, _, wall_p = _generate(model, tokens, dtype)
            # the plain route fed the kernel route's tokens, so each step's
            # logits are compared on the same inputs even where a near-tie
            # sends the two greedy paths apart (bf16)
            lg_p = _forced_logits(model, tokens, tok_k, dtype)
        if any(read_counts().values()):
            raise AssertionError(f"the plain route launched a kernel: "
                                 f"{read_counts()}")
        if lg_k.shape != (BATCH, NEW, cfg.vocab_size) or \
                not torch.isfinite(lg_k).all():
            raise AssertionError(f"LM logits {tuple(lg_k.shape)} not finite "
                                 f"or of the wrong shape")
        scale = max(1.0, float(lg_p.float().abs().max()))
        err_prefill = float((lg_k[:, 0] - lg_p[:, 0]).float().abs().max())
        err_steps = float((lg_k[:, 1:] - lg_p[:, 1:]).float().abs().max())
        tol = LOGIT_TOL[dtype] * scale
        same = bool(np.array_equal(tok_k, tok_p))
        name = str(dtype)[6:]
        print(f"LM main path [{ARCH} {name}, B{BATCH} prompt {PROMPT} + "
              f"{NEW} new, max_len {MAX_LEN}]: launches {counts}; logits "
              f"kernel vs plain (fed the kernel route's tokens) max abs err "
              f"prefill {err_prefill:.3e}, "
              f"decode steps {err_steps:.3e} (tolerance {LOGIT_TOL[dtype]:g}"
              f" x {scale:.3g}); greedy tokens equal: {same}; wall "
              f"generate kernel {wall_k:.3f} s, plain {wall_p:.3f} s; "
              f"tokens[0] {tok_k[0].tolist()}", flush=True)
        if max(err_prefill, err_steps) > tol:
            raise AssertionError(f"LM logits of the kernel route differ from "
                                 f"the plain route ({name})")
        if dtype == torch.float32 and not same:
            raise AssertionError("greedy tokens differ in float32")
        out[name] = dict(counts=counts, err=max(err_prefill, err_steps))
    return out


def phase_lm_small_reference():
    """A reduced SmolLM (GQA 4/2, head_dim 32) generates on the card through
    the kernels and on the CPU through the plain versions, same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=4,
                              n_kv_heads=2)
    cpu = build_model(cfg, device="cpu", seed=SEED)
    card = build_model(cfg, device=DEV, seed=None)
    card.load_state_dict(cpu.state_dict())
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    sc = ServeConfig(max_len=64, max_new_tokens=12)
    t_card, l_card = Engine(card, sc).generate({"tokens": tok.to(DEV)},
                                               return_logits=True)
    t_cpu, l_cpu = Engine(cpu, sc).generate({"tokens": tok},
                                            return_logits=True)
    err = float((l_card.cpu() - l_cpu).abs().max())
    scale = max(1.0, float(l_cpu.abs().max()))
    ok = err <= LOGIT_TOL[torch.float32] * scale and np.array_equal(t_card,
                                                                    t_cpu)
    print(f"LM small reference [reduced {ARCH}, cuda kernels vs cpu plain]: "
          f"logits max abs err {err:.3e}, tokens equal "
          f"{np.array_equal(t_card, t_cpu)} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("LM on the card disagrees with the CPU")


def attention_bound(name, case):
    """Least time for one call: q, k, v, o (decode: live cache slots only)
    read or written once over HBM bandwidth, or the live (query, key) pairs'
    4 D flops over the dtype's peak, whichever is larger."""
    q, k = case["q"], case["k"]
    b, _, h, d = q.shape
    live = int(case["lengths"].sum()) if name == "decode" else None
    return shape_bound(name, q.dtype, b, q.shape[1], h, k.shape[2], d, live)


def cache_bound(case):
    """Least time for one cache attention call: q, k, v, the positions and
    o read or written once, or the flops this call's mask needs, 4 D a
    live (query, head, slot) and 2 D a slot of a query with none (the mean
    of V), over the dtype's peak, whichever is larger."""
    from repro_torch.kernels.cache_attention import cache_mask
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    es = q.element_size()
    mask = cache_mask(case["q_pos"], case["k_pos"], case["window"])
    live = int(mask.sum())
    dead = int((~mask.any(-1)).sum())
    nbytes = es * (2 * b * s * h * d + 2 * b * t * hkv * d) + 4 * b * (s + t)
    flops = h * d * (4 * live + 2 * dead * t)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_OPS[q.dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def shape_bound(name, dtype, b, s, h, hkv, d, live=None):
    """``attention_bound`` from shapes: flash over a causal sequence of s
    (no window); decode over ``live`` cache slots in all, one query each."""
    es = torch.empty((), dtype=dtype).element_size()
    if name == "flash":
        nbytes = es * (2 * b * s * h * d + 2 * b * s * hkv * d)
        pairs = b * h * s * (s + 1) // 2
    else:
        nbytes = es * (2 * b * h * d + 2 * live * hkv * d) + 4 * b
        pairs = h * live
    flops = 4 * d * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_OPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def design(name, dtype, d=64):
    """The kernel a call launches (decode attention has one design)."""
    from repro_torch.kernels.cache_attention import design as cache_design
    from repro_torch.kernels.flash_attention import design as flash_design
    if name == "cache":
        return cache_design(dtype, d)
    return flash_design(dtype, d) if name == "flash" else "split+merge"


def _sdpa(name, case, mask=None):
    """SDPA on the case (cache: with ``mask`` where given, else with the
    boolean mask built inside the call)."""
    import torch.nn.functional as F
    q, k, v = (case[x].transpose(1, 2) for x in ("q", "k", "v"))
    if name == "cache":
        if mask is None:
            mask = _sdpa_mask(case)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    if name == "flash":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    t = k.shape[2]
    mask = (torch.arange(t, device=DEV)[None, :]
            < case["lengths"][:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def _sdpa_mask(case):
    """The cache case's boolean mask as SDPA takes it, (B, 1, S, T)."""
    from repro_torch.kernels.cache_attention import cache_mask
    return cache_mask(case["q_pos"], case["k_pos"], case["window"])[:, None]


#: the attention kernels as the profiler names them
_PROFILE_KERNELS = {"flash": ("flash_wgmma_kernel", "flash_kernel"),
                    "decode": ("decode_split_kernel", "decode_merge_kernel"),
                    "cache": ("cache_attention_kernel", "cache_wgmma_kernel",
                              "cache_merge_kernel")}


def _rotating_ms(fn, cases, reps):
    """Per-call time over ``reps`` calls that cycle through ``cases`` (more
    bytes than the 50 MB L2 holds, as a model's layers would find them)."""
    for c in cases:
        fn(c)
    i = [0]

    def step():
        fn(cases[i[0] % len(cases)])
        i[0] += 1
    return _events_ms(step, reps)


def _host_ms(fn, cases, reps):
    """Host time to enqueue one call (no synchronize inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(cases[i % len(cases)])
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / reps


#: calls a profiler session times: it misses a session's first 8-16
#: launches (§7 of PERF.md), and late in a run once all of the first 20
PROFILE_CALLS = 50


#: profiler sessions a device time is asked of before it fails: late in a
#: run a session can record no kernel at all (none of 50 zamba2 bf16
#: flash launches in one whole run, every one in the run before it)
PROFILE_SESSIONS = 3


def _device_ms_per_call(fn, cases, reps, keys):
    """Device time per call of the kernels whose names hold one of
    ``keys`` (each launched once a call), by torch.profiler: the kernels
    alone, without the gaps the host leaves between calls.  Each kernel's
    mean over the launches the profiler recorded, which can be fewer than
    ``reps`` (then printed); a session that recorded none is run again, up
    to PROFILE_SESSIONS (printed); none recorded in any raises."""
    from torch.profiler import ProfilerActivity, profile
    for session in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(cases[i % len(cases)])
            torch.cuda.synchronize()
        events = prof.key_averages()
        found = [e for e in events
                 if any(k in e.key for k in keys) and _device_ms(e) > 0]
        if found:
            break
        print(f"profiler: session {session + 1} recorded no device time "
              f"of {keys}", flush=True)
    if not found:
        seen = sorted(events, key=_device_ms, reverse=True)[:5]
        raise AssertionError(
            f"the profiler saw no device time of {keys}; it saw "
            f"{[(e.key[:60], round(_device_ms(e), 4)) for e in seen]}")
    short = [(e.key[:48], e.count) for e in found if e.count != reps]
    if short:
        print(f"profiler: recorded launches {short} of {reps} calls",
              flush=True)
    return sum(_device_ms(e) / e.count for e in found)


#: the shapes each attention kernel is timed at: (label, B, S of flash, T
#: of decode and its lengths' range, H, Hkv, D, copies of a flash and a
#: decode case cycled through, more bytes than the 50 MB L2 holds, repeats
#: of kernel and SDPA in turns, their median kept: at zamba2's small shape
#: SDPA's time moves by half from call to call)
TIMING_SHAPES = {
    "smollm": ("SmolLM-360M one layer", BATCH, PROMPT, MAX_LEN,
               (PROMPT, MAX_LEN - 8), 15, 5, 64, 2, 5, 1),
    "zamba2": ("zamba2-7b shared attention", 2, 256, 280, (256, 272), 32,
               32, 112, 4, 5, 5)}


def _median_of_turns(fns, repeats):
    """Each of ``fns`` (returning ms) run ``repeats`` times in turns, the
    order reversed on odd repeats so that neither side always goes first;
    per function its median and the readings."""
    got = [[] for _ in fns]
    for rep in range(repeats):
        turn = list(zip(got, fns))
        for reads, fn in (turn[::-1] if rep % 2 else turn):
            reads.append(fn())
    return [(float(np.median(r)), r) for r in got]


def _spread(reads):
    return (f" (median of {len(reads)} in turns with SDPA, "
            f"{min(reads):.4f}-{max(reads):.4f})" if len(reads) > 1 else "")


def phase_attention_timing(errs):
    """Each attention kernel at the main path's shapes (SmolLM-360M) and at
    zamba2-7b's head_dim 112: kernel, plain version and SDPA per call by
    CUDA events (at zamba2 the median of 5 repeats, kernel and SDPA in
    turns), and the bound.  Rows keyed (kernel, dtype) for SmolLM,
    (kernel, dtype, "zamba2") for zamba2."""
    rows = {}
    for shape, (label, bb, ss, tt, lrange, hh, hkv, dd, n_flash,
                n_decode, repeats) in TIMING_SHAPES.items():
        lens = np.random.default_rng(2).integers(*lrange, bb).tolist()
        for dtype in (torch.float32, torch.bfloat16):
            name_dt = str(dtype)[6:]
            for name, n_copies in (("flash", n_flash), ("decode", n_decode)):
                def make(i, name=name, dtype=dtype, lens=lens):
                    if name == "flash":
                        return flash_case(bb, ss, hh, hkv, dd, dtype,
                                          seed=10 * i)
                    return decode_case(bb, tt, hh, hkv, dd, lens, dtype,
                                       seed=10 * i)
                cases = [make(i) for i in range(n_copies)]
                kernel = lambda c, name=name: _attn_kernel(name, c)  # noqa
                sdpa = lambda c, name=name: _sdpa(name, c)  # noqa
                (ms, ms_reads), (lib_ms, lib_reads) = _median_of_turns(
                    (lambda: _rotating_ms(kernel, cases, 50),
                     lambda: _rotating_ms(sdpa, cases, 50)), repeats)
                plain_ms = _rotating_ms(
                    lambda c, name=name: _attn_plain(name, c), cases, 5)
                host_ms = _host_ms(kernel, cases, 50)
                device_ms = _device_ms_per_call(kernel, cases, 50,
                                                _PROFILE_KERNELS[name])
                b = attention_bound(name, cases[0])
                row = dict(design=design(name, dtype, dd), ms=ms,
                           ms_reads=ms_reads, library_ms_reads=lib_reads,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           host_ms=host_ms, device_ms=device_ms,
                           max_abs_err=errs[(name, dtype)],
                           share_of_bound=b["bound_ms"] / ms,
                           device_share_of_bound=b["bound_ms"] / device_ms,
                           **b)
                key = (name, name_dt) if shape == "smollm" else (
                    name, name_dt, shape)
                rows[key] = row
                print(f"timing [{name} {name_dt} ({row['design']}), {label}"
                      f"{', lengths ' + str(lens) if name == 'decode' else ''}"
                      f"]: kernel {ms:.4f} ms/call{_spread(ms_reads)}, "
                      f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms"
                      f"{_spread(lib_reads)}, bound {b['bound_ms']:.5f} ms "
                      f"({b['bound_by']}; {b['bytes'] / 1e6:.2f} MB, "
                      f"{b['flops'] / 1e9:.3f} GFLOP), kernel at "
                      f"{100 * row['share_of_bound']:.1f}% of the bound; "
                      f"device time {device_ms:.4f} ms/call "
                      f"({100 * row['device_share_of_bound']:.1f}% of the "
                      f"bound), host enqueue {host_ms:.4f} ms/call "
                      f"[{card_line()}]", flush=True)
    return rows


#: the shapes the cache attention kernel is timed at: (label, B, S, T, H,
#: Hkv, D, window, copies cycled through, repeats of kernel and SDPA in
#: turns): SmolLM-360M's later prompt segments (256 tokens over the
#: 1,064-slot cache of phase_cache_segments), zamba2-7b's 64-token
#: continuation and mixtral-8x7b's 256 tokens into its wrapped 4,096-slot
#: ring (phase_cache_segments (b))
CACHE_TIMING = {
    "smollm": ("SmolLM-360M segment, one layer", BATCH, 256, MAX_LEN, 15, 5,
               64, None, 4, 1),
    "zamba2": ("zamba2-7b shared attention segment", 2, 64, 328, 32, 32,
               112, None, 8, 5),
    "mixtral": ("mixtral-8x7b segment into the wrapped ring", 1, 256, 4096,
                32, 8, 128, 4096, 3, 1)}


def phase_cache_timing(errs):
    """The cache attention kernel at CACHE_TIMING's shapes (``cache_case``:
    row 0 all masked), f32 and bf16: kernel, plain version and SDPA with
    the boolean mask per call by CUDA events (the median of the repeats,
    kernel and SDPA in turns; the mask built once a case, outside the
    timed call, and SDPA with the mask built inside the call, as the
    column was first timed, once beside it), the host's enqueue time, the
    profiler's device time, and the bound (``cache_bound``).  Rows keyed
    (dtype,) for SmolLM, (dtype, shape) for the others."""
    rows = {}
    for shape, (label, bb, ss, tt, hh, hkv, dd, window, n_copies,
                repeats) in CACHE_TIMING.items():
        for dtype in (torch.float32, torch.bfloat16):
            name_dt = str(dtype)[6:]
            cases = [cache_case(bb, ss, tt, hh, hkv, dd, dtype, window,
                                seed=10 * i) for i in range(n_copies)]
            masked = [(c, _sdpa_mask(c)) for c in cases]
            kernel = lambda c: _attn_kernel("cache", c)  # noqa: E731
            sdpa = lambda cm: _sdpa("cache", *cm)  # noqa: E731
            (ms, ms_reads), (lib_ms, lib_reads) = _median_of_turns(
                (lambda: _rotating_ms(kernel, cases, 50),
                 lambda: _rotating_ms(sdpa, masked, 50)), repeats)
            lib_inside_ms = _rotating_ms(lambda c: _sdpa("cache", c), cases,
                                         50)
            plain_ms = _rotating_ms(lambda c: _attn_plain("cache", c),
                                    cases, 5)
            host_ms = _host_ms(kernel, cases, 50)
            device_ms = _device_ms_per_call(kernel, cases, 50,
                                            _PROFILE_KERNELS["cache"])
            b = cache_bound(cases[0])
            row = dict(design=design("cache", dtype, dd), ms=ms,
                       ms_reads=ms_reads, library_ms_reads=lib_reads,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_mask_inside_ms=lib_inside_ms,
                       host_ms=host_ms, device_ms=device_ms,
                       max_abs_err=errs[("cache", dtype)],
                       share_of_bound=b["bound_ms"] / ms,
                       device_share_of_bound=b["bound_ms"] / device_ms, **b)
            rows[(name_dt,) if shape == "smollm" else (name_dt, shape)] = row
            print(f"timing [cache {name_dt} ({row['design']}), {label}, B"
                  f"{bb} S{ss} T{tt} H{hh}/{hkv} D{dd}"
                  f"{f' window {window}' if window else ''}, chunk "
                  f"{_cache_chunk(cases[0])}]: kernel {ms:.4f} "
                  f"ms/call{_spread(ms_reads)}, plain {plain_ms:.4f} ms, "
                  f"SDPA with the mask {lib_ms:.4f} ms{_spread(lib_reads)} "
                  f"(the mask built inside the call: {lib_inside_ms:.4f} "
                  f"ms), "
                  f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}; "
                  f"{b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e9:.3f} "
                  f"GFLOP), kernel at {100 * row['share_of_bound']:.1f}% of "
                  f"the bound; device time {device_ms:.4f} ms/call "
                  f"({100 * row['device_share_of_bound']:.1f}% of the "
                  f"bound), host enqueue {host_ms:.4f} ms/call "
                  f"[{card_line()}]", flush=True)
    return rows


def _cache_chunk(case):
    """The slots a block of the cache kernel takes on this case
    (``split_plan``)."""
    from repro_torch.kernels.cache_attention import split_plan
    b, s, h, d = case["q"].shape
    t, hkv = case["k"].shape[1:3]
    return split_plan(b, s, h, hkv, t, d, case["q"].dtype,
                      torch.cuda.get_device_properties(DEV)
                      .multi_processor_count)


def _serve_times(model, tokens, dtype):
    """Host-clock prefill time and decode time per token (greedy)."""
    steps = NEW - 1
    cache = model.init_cache(BATCH, MAX_LEN, dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens}, cache, dtype=dtype)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(
            torch.argmax(logits, -1).to(torch.int32), cache, dtype=dtype)
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1) / steps


def phase_serve_timing(lm):
    """End to end: prefill ms and decode ms per token, kernel route and
    plain route, in turns (kernel, plain, plain, kernel)."""
    model, tokens = lm["model"], lm["tokens"]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        got = {"kernel": [], "plain": []}
        for route in ("kernel", "plain", "plain", "kernel"):
            with _route(route):
                got[route].append(_serve_times(model, tokens, dtype))
        rows[name] = got
        for route, runs in got.items():
            print(f"serve timing [{ARCH} {name} {route} route, B{BATCH}]: "
                  f"prefill {runs[0][0]:.2f} / {runs[1][0]:.2f} ms "
                  f"({BATCH * PROMPT / runs[1][0] * 1e3:.0f} tokens/s), "
                  f"decode {runs[0][1]:.3f} / {runs[1][1]:.3f} ms per step "
                  f"({BATCH / runs[1][1] * 1e3:.0f} tokens/s) "
                  f"[{card_line()}]", flush=True)
    return rows


def _device_ms(event) -> float:
    return getattr(event, "self_device_time_total", 0) / 1e3


def phase_lm_profile(lm):
    """Where a prefill's and a decode step's time goes (torch.profiler,
    kernel route, f32 and bf16, after the runs above warmed it up), and
    each attention kernel's device time per call beside its bound."""
    from torch.profiler import ProfilerActivity, profile
    model, tokens = lm["model"], lm["tokens"]
    cfg = model.cfg
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        cache = model.init_cache(BATCH, MAX_LEN, dtype=dtype)
        for label, steps in (("prefill", 1), ("decode", 8)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if label == "prefill":
                    logits, cache = model.prefill({"tokens": tokens}, cache,
                                                  dtype=dtype)
                else:
                    for _ in range(steps):
                        logits, cache = model.decode_step(
                            torch.argmax(logits, -1).to(torch.int32), cache,
                            dtype=dtype)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) is not None
                      and "CUDA" in str(e.device_type)]
            dev_us = sum(getattr(e, "self_device_time_total", 0)
                         for e in events)
            top = sorted(events, key=lambda e: -getattr(
                e, "self_device_time_total", 0))[:6]
            print(f"profile [{ARCH} {name_dt} kernel route, {label} "
                  f"x{steps}]: wall {1e3 * wall / steps:.3f} ms per call, "
                  f"device busy {dev_us / 1e3 / steps:.3f} ms "
                  f"({100 * dev_us / 1e6 / wall:.1f}% of wall), "
                  f"{sum(e.count for e in events) / steps:.0f} device kernels"
                  f" per call; top by device time: " + "; ".join(
                      f"{e.key[:50]} x{e.count} {_device_ms(e) / steps:.3f} "
                      f"ms" for e in top), flush=True)
            name = "flash" if label == "prefill" else "decode"
            mine = [e for e in events
                    if any(k in e.key for k in _PROFILE_KERNELS[name])]
            calls = cfg.n_layers * steps
            kern_ms = sum(_device_ms(e) for e in mine)
            if label == "prefill":
                b = shape_bound("flash", dtype, BATCH, PROMPT, h, hkv, d)
                bound_ms = b["bound_ms"]
            else:   # the steps read PROMPT + 1 .. PROMPT + steps slots
                bound_ms = sum(shape_bound(
                    "decode", dtype, BATCH, 1, h, hkv, d,
                    BATCH * (PROMPT + 1 + i))["bound_ms"]
                    for i in range(steps)) / steps
            per_call = kern_ms / calls
            print(f"profile [{name} kernel ({design(name, dtype, d)}) "
                  f"{name_dt}, {label}]: "
                  + ", ".join(f"{e.key[:40]} x{e.count} "
                              f"{_device_ms(e) / steps:.3f} ms" for e in mine)
                  + f"; {kern_ms / steps:.3f} ms device time per {label} "
                  f"({calls // steps} calls), {1e3 * per_call:.2f} us per "
                  f"call, bound {1e3 * bound_ms:.2f} us: "
                  f"{100 * bound_ms / per_call if per_call else 0:.1f}% of "
                  f"the bound", flush=True)


def _traced(fn, activities):
    """(wall s, device ms, device kernels) of ``fn()`` under torch.profiler."""
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    return (wall, sum(_device_ms(e) for e in events),
            sum(e.count for e in events))


def phase_eval_profile(drivers, rounds=2):
    """Where a local-engine round goes on each driver (Vehicle Sensor, the
    main path's regularizer), from torch.profiler traces: ``rounds``
    replays of the pre-sampled driver's own program (``mocha.
    _scanned_program``, its CUDA graph captured before the window, replayed
    through the driver's ``_replay_rounds``), then a whole ``rounds``-round
    loop-driver run (device activity only: the loop's ~42k launches a round
    would add ~4 host events each).  Each trace's device time per round
    over the un-traced wall per round of that driver (phase_eval_path) is
    its device-busy share.  The replay window holds rounds only; the loop
    run also its set-up and per-round metrics, as both walls do.  Run after
    every other profile: after a profile
    of whole scanned and loop runs (~10^6 events) later profiles in the
    same process read low device times."""
    from torch.profiler import ProfilerActivity
    from repro_torch.core import Clustered, MochaConfig
    from repro_torch.core.mocha import (_replay_rounds, _scanned_program,
                                        _start)
    from repro_torch.data.synthetic import VEHICLE_SENSOR, make_federation
    train = make_federation(VEHICLE_SENSOR, seed=0)[0]
    reg = Clustered(lam=1.0, k=3)
    run = _start(train, reg, MochaConfig(rounds=rounds + 1,
                                         omega_update_every=5,
                                         driver="scan"))
    keys, budgets, prog, _ = _scanned_program(run)
    prog.run()                      # the first round, before the window
    wall, dev_ms, kernels = _traced(
        lambda: _replay_rounds(prog, keys[1:], budgets[1:],
                               run.cfg.omega_update_every, run.omega_step),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    loop_exp = _local_exp(train, reg, "loop", 5, rounds=rounds)
    loop_wall, loop_dev_ms, loop_kernels = _traced(
        lambda: loop_exp.run(0), [ProfilerActivity.CUDA])
    vs = drivers["vehicle_sensor"]
    row = dict(replay_wall_ms=1e3 * wall / rounds,
               device_ms=dev_ms / rounds, kernels=kernels / rounds,
               loop_traced_wall_ms=1e3 * loop_wall / rounds,
               loop_device_ms=loop_dev_ms / rounds,
               loop_kernels=loop_kernels / rounds)
    row.update(busy_replay=row["device_ms"] / row["replay_wall_ms"],
               busy_scan=row["device_ms"]
               / vs["scan_ms_per_round_after_capture"],
               busy_loop=row["loop_device_ms"] / vs["loop_ms_per_round"])
    print(f"profile [vehicle_sensor local engine, {rounds} rounds each]: "
          f"pre-sampled driver (graph replays) wall "
          f"{row['replay_wall_ms']:.2f} ms/round traced, device busy "
          f"{row['device_ms']:.3f} ms/round, {row['kernels']:.0f} device "
          f"kernels/round; loop driver wall {row['loop_traced_wall_ms']:.2f}"
          f" ms/round traced, device busy {row['loop_device_ms']:.3f} "
          f"ms/round, {row['loop_kernels']:.0f} device kernels/round; "
          f"device busy over the un-traced walls per round: scan "
          f"{100 * row['busy_scan']:.1f}% "
          f"({vs['scan_ms_per_round_after_capture']:.2f} ms after the "
          f"capture), loop {100 * row['busy_loop']:.1f}% "
          f"({vs['loop_ms_per_round']:.2f} ms) [{card_line()}]", flush=True)
    return row


# ---------------------------------------------------------------------------
# The MOCHA serving tier, the personalization bridge and LM training
# ---------------------------------------------------------------------------

#: the serving tier's reads: uniformly drawn client ids and random features
SERVE_BATCH = 1024
#: the served cohort's size (cohort_1m's larger K)
SERVE_K = 256
#: (engine, overlap) of the served cohort_1m runs: the kernel engine (one
#: SDCA launch a block) at overlap 1 and 4, and the local engine (one
#: captured round program a run, beside the reads) at overlap 4
SERVE_RUNS = (("kernel", 1), ("kernel", COHORT_OVERLAP),
              ("local", COHORT_OVERLAP))
#: a margin against the host rule's weights: d float32 products summed in
#: another order
MARGIN_TOL = dict(rtol=1e-5, atol=1e-6)


def _served(before, after, version):
    """The snapshot a read was answered from (the predictor's mirrored
    version), of the two current before and after it; None if neither."""
    for snap in (before, after):
        if snap.version == version:
            return snap
    return None


def serve_reads(sess, rng, m, d):
    """Read on this thread until training ends: ``SERVE_BATCH`` uniform ids
    with random features a read, each answer held against the host rule
    of the snapshot it was answered from.  Returns (latencies s, reads
    checked)."""
    lat, checked = [], 0
    while sess.training:
        ids = rng.integers(0, m, SERVE_BATCH)
        X = rng.normal(size=(SERVE_BATCH, d)).astype(np.float32)
        before = sess.store.current()
        t0 = time.perf_counter()
        z = sess.predict(ids, X)
        lat.append(time.perf_counter() - t0)
        snap = _served(before, sess.store.current(),
                       sess.predictor.snapshot_version)
        if snap is None:
            continue
        want = np.einsum("bd,bd->b", snap.client_weights(ids), X)
        if z.shape != (SERVE_BATCH,) or not np.allclose(z, want,
                                                        **MARGIN_TOL):
            raise AssertionError(f"serve: an answer of version "
                                 f"{snap.version} differs from the host rule")
        checked += 1
    return lat, checked


def phase_serve_tier():
    """The MOCHA serving tier: ``Experiment.serve()`` over CROSS_DEVICE_1M
    (10^6 clients, d 32) at K 256 for COHORT_BLOCKS blocks, a snapshot
    published every fold, training on a background thread while this
    thread predicts batches of SERVE_BATCH uniformly drawn clients.  Per
    run: the session's result equal to ``Experiment.run`` bit for bit, the
    lookup on the card equal to the host rule, every answer equal to the
    host rule of its snapshot, the max version lag <= 1, COHORT_BLOCKS
    publishes + the prewarm, one SDCA launch a kernel-engine block and one
    capture a local-engine run (counters set to 0 just before each session
    and read just after)."""
    from repro_torch.api import Serve
    from repro_torch.cohort import CROSS_DEVICE_1M, Population
    from repro_torch.core import RoundProgram
    card = card_line()
    t_phase = time.perf_counter()
    pop = Population(CROSS_DEVICE_1M, seed=0)
    rng = np.random.default_rng(0)
    rows, launches = {}, 0
    for engine, overlap in SERVE_RUNS:
        exp = _cohort_exp(pop, SERVE_K, engine, overlap, rounds=COHORT_BLOCKS)
        ref, ref_s = _run_timed(exp)
        before = RoundProgram.captures
        reset_all_counts()
        sess = exp.serve(0, Serve(publish_every=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.start()
        lat, checked = serve_reads(sess, rng, pop.m, CROSS_DEVICE_1M.d)
        res = sess.join(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = read_counts()["sdca_local_solve"]
        captures = RoundProgram.captures - before
        want = (0, COHORT_BLOCKS) if engine == "kernel" else (1, 0)
        if (captures, n_launch) != want:
            raise AssertionError(
                f"serve {engine} overlap {overlap}: {captures} captures, "
                f"{n_launch} SDCA launches in {COHORT_BLOCKS} blocks "
                f"(expected {want})")
        launches += n_launch
        _same_cohort_bits(f"serve {engine} overlap {overlap}: serving on vs "
                          "off", ref.result, res)
        lag = sess.predictor.max_version_lag
        if sess.store.swap_count != COHORT_BLOCKS + 1 or lag > 1:
            raise AssertionError(f"serve: {sess.store.swap_count} publishes, "
                                 f"max version lag {lag}")
        ids = rng.integers(0, pop.m, SERVE_BATCH)
        if not np.array_equal(sess.predictor.lookup(ids),
                              sess.store.current().client_weights(ids)):
            raise AssertionError("serve: the lookup on the card differs "
                                 "from the host rule")
        if not lat:
            raise AssertionError("serve: no read ran beside training")
        ms = 1e3 * np.asarray(lat)
        row = dict(reads=len(lat), reads_checked=checked,
                   p50_ms=float(np.percentile(ms, 50)),
                   p99_ms=float(np.percentile(ms, 99)),
                   lookups_per_s=SERVE_BATCH * len(lat) / float(np.sum(lat)),
                   max_version_lag=lag, publishes=sess.store.swap_count,
                   launches=n_launch, captures=captures, wall_s=wall,
                   unserved_wall_s=ref_s,
                   final_primal=float(res.history["primal"][-1]))
        rows[f"{engine}_overlap{overlap}"] = row
        print(f"serve tier [cross_device_1m K={SERVE_K} {engine} overlap "
              f"{overlap}, {COHORT_BLOCKS} blocks, publish every fold]: "
              f"{len(lat)} reads of {SERVE_BATCH} beside training "
              f"({checked} held against their snapshot's host rule), "
              f"predict p50 {row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} "
              f"ms, {row['lookups_per_s']:.0f} lookups/s, max version lag "
              f"{lag}, {row['publishes']} publishes, SDCA launches "
              f"{n_launch}, captures {captures}; served run {wall:.3f} s vs "
              f"unserved {ref_s:.3f} s, equal bit for bit [{card}]",
              flush=True)
    # the predictor alone (no training beside it), on the final snapshot
    ids = rng.integers(0, pop.m, SERVE_BATCH)
    X = rng.normal(size=(SERVE_BATCH, CROSS_DEVICE_1M.d)).astype(np.float32)
    for _ in range(5):
        sess.predict(ids, X)
    t0 = time.perf_counter()
    for _ in range(50):
        sess.predict(ids, X)
    idle_ms = 1e3 * (time.perf_counter() - t0) / 50
    wall = time.perf_counter() - t_phase
    print(f"serve tier: predict alone {idle_ms:.3f} ms a batch of "
          f"{SERVE_BATCH} ({1e3 * SERVE_BATCH / idle_ms:.0f} lookups/s); "
          f"phase {wall:.1f} s [{card}]", flush=True)
    return dict(runs=rows, launches=launches, idle_predict_ms=idle_ms,
                wall_s=wall)


#: personalization: SmolLM-360M features of 8 tasks of 16-72 sequences of
#: 128 tokens, labels from the token topic (tests/test_serve.py:72-100)
PERS_TASKS, PERS_SEQ = 8, 128
#: features, kernel route vs plain route: 32 layers of the flash kernel's
#: f32 rounding, as LOGIT_TOL[float32] holds the logits
FEAT_TOL = 1e-4


def _topic_tasks(vocab):
    rng = np.random.default_rng(SEED)
    batches, labels = [], []
    for t in range(PERS_TASKS):
        n = 16 + 8 * t
        lab = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        lo, hi = (0, vocab // 2) if t % 2 else (vocab // 2, vocab)
        toks = np.zeros((n, PERS_SEQ), np.int32)
        for i in range(n):
            toks[i] = (rng.integers(lo, hi, PERS_SEQ) if lab[i] > 0
                       else rng.integers(0, vocab, PERS_SEQ))
        batches.append({"tokens": toks})
        labels.append(lab)
    return batches, labels


def _hold_call(tally, label, name, out, ref, tol):
    """One kernel call's output against its plain version's: ``tally``
    gathers the calls and the largest share of the tolerance."""
    share = float(((out.float() - ref.float()).abs() / tol).max())
    tally["calls"] = tally.get("calls", 0) + 1
    tally["share"] = max(tally.get("share", 0.0), share)
    if not share <= 1.0:
        raise AssertionError(f"{label}: a {name} call exceeds its "
                             f"tolerance ({share:.3f} of it)")


@contextlib.contextmanager
def held_flash_calls(tally, label):
    """Every flash_mha call of the model's layers held against the plain
    version on its inputs within ``flash_tolerance``; ``tally`` gathers
    the calls and the largest share of the tolerance.  The kernel's output
    is what the layer gets (and differentiates through)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_tolerance)
    from repro_torch.models import layers
    saved = layers.flash_mha

    def flash(q, k, v, causal=True, window=None):
        out = saved(q, k, v, causal=causal, window=window)
        with torch.no_grad():
            ref = attention_ref(q, k, v, causal=causal, window=window)
            tol = flash_tolerance(q, k, v, ref, causal=causal,
                                  window=window)
            _hold_call(tally, label, "flash", out, ref, tol)
        return out

    layers.flash_mha = flash
    try:
        yield
    finally:
        layers.flash_mha = saved


@contextlib.contextmanager
def held_decode_calls(tally, label):
    """Every decode_mha call of the model's layers (a window's ring steps
    too) held against ``decode_attention_ref`` on its inputs within
    ``attention_tolerance``; ``tally`` as in ``held_flash_calls``."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import attention_tolerance
    from repro_torch.models import layers
    saved = layers.decode_mha

    def decode(q, k, v, lengths):
        out = saved(q, k, v, lengths)
        with torch.no_grad():
            ref = decode_attention_ref(q[:, 0], k, v, lengths)[:, None]
            _hold_call(tally, label, "decode", out, ref,
                       attention_tolerance(ref))
        return out

    layers.decode_mha = decode
    try:
        yield
    finally:
        layers.decode_mha = saved


@contextlib.contextmanager
def held_cache_calls(tally, label):
    """Every cache_mha call of the model's layers held against
    ``cache_attention_ref`` on its inputs within ``cache_tolerance`` (the
    bf16 tensor-core design's P rounding included); ``tally`` as in
    ``held_flash_calls``."""
    from repro_torch.kernels.cache_attention import (cache_attention_ref,
                                                     cache_tolerance)
    from repro_torch.models import layers
    saved = layers.cache_mha

    def cache(q, k, v, q_pos, k_pos, window=None, return_lse=False):
        out = saved(q, k, v, q_pos, k_pos, window, return_lse=return_lse)
        with torch.no_grad():
            ref = cache_attention_ref(q, k, v, q_pos, k_pos, window=window)
            got = out[0] if return_lse else out
            _hold_call(tally, label, "cache", got, ref,
                       cache_tolerance(q, k, v, q_pos, k_pos, ref, window))
        return out

    layers.cache_mha = cache
    try:
        yield
    finally:
        layers.cache_mha = saved


def phase_personalize():
    """The personalization bridge on SmolLM-360M at full width (random
    weights, seed 0): features through the flash kernel (each call held
    against the plain version within flash_tolerance, the pooled features
    against the plain route within FEAT_TOL), then ``fit`` with the default
    smooth_hinge on the local engine and with hinge on the kernel engine
    (d 960: the SDCA kernel's wide-carry branch), held against the local
    engine's hinge run within HISTORY_RTOL; per-task accuracy.  Counters
    set to 0 just before the path and read just after."""
    from repro_torch.core import MochaConfig, Probabilistic
    from repro_torch.core.personalization import PersonalizationBridge
    card = card_line()
    t_phase = time.perf_counter()
    model = _lm_model()
    cfg = model.cfg
    batches, labels = _topic_tasks(cfg.vocab_size)
    bridge = PersonalizationBridge(model, Probabilistic(lam=1e-3,
                                                        sigma2=10.0))
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = bridge.build_federation(batches, labels)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    res = bridge.fit(fed)
    kernel_bridge = dataclasses.replace(bridge, mocha=MochaConfig(
        loss="hinge", rounds=bridge.mocha.rounds, engine="kernel"))
    res_k = kernel_bridge.fit(fed)
    accs = [float((torch.sign(bridge.predict(b, res.W[t])).cpu().numpy()
                   == labels[t]).mean()) for t, b in enumerate(batches)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_rows = sum(b["tokens"].shape[0] for b in batches)
    want = {"flash_attention": 2 * PERS_TASKS * cfg.n_layers,
            "sdca_local_solve": bridge.mocha.rounds, "decode_attention": 0,
            "cache_attention": 0}
    if counts != want:
        raise AssertionError(f"personalize launches {counts}, expected "
                             f"{want}")
    if fed.X.shape != (PERS_TASKS, 16 + 8 * (PERS_TASKS - 1), cfg.d_model) \
            or not torch.isfinite(fed.X).all():
        raise AssertionError(f"personalize: features {tuple(fed.X.shape)}")
    # the route comparison, outside the counted path
    tally = {}
    with held_flash_calls(tally, "personalize"):
        f_k = bridge.features(batches[-1])
    with plain_attention():
        f_p = bridge.features(batches[-1])
    feat_err = float((f_k - f_p).abs().max())
    if feat_err > FEAT_TOL * max(1.0, float(f_p.abs().max())):
        raise AssertionError(f"personalize: features differ by {feat_err:.3e}"
                             " between the kernel and plain routes")
    local_hinge = dataclasses.replace(bridge, mocha=MochaConfig(
        loss="hinge", rounds=bridge.mocha.rounds)).fit(fed)
    rel = _compare_histories("personalize hinge kernel vs local",
                             res_k.history, local_hinge.history)
    if not np.isfinite(res.final("gap")) or np.mean(accs) <= 0.5:
        raise AssertionError(f"personalize: gap {res.final('gap')}, "
                             f"accuracy {accs}")
    kernel = personalize_kernel_timing(fed, card)
    print(f"personalize [{ARCH} full width, {PERS_TASKS} tasks of 16-72 x "
          f"{PERS_SEQ} tokens, {n_rows} sequences, d {cfg.d_model}]: "
          f"launches {counts}; features {1e3 * feat_s:.1f} ms "
          f"({n_rows * PERS_SEQ / feat_s:.0f} tokens/s), kernel vs plain "
          f"route max abs err {feat_err:.3e} (tolerance {FEAT_TOL:g} x "
          f"max(1, max|f|)), {tally['calls']} flash calls within "
          f"flash_tolerance (largest share {tally['share']:.3f}); "
          f"smooth_hinge local gap {res.final('gap'):.4g}, hinge kernel "
          f"(wide carry) vs local history max rel diff {rel:.3e}; per-task "
          f"accuracy {[round(a, 3) for a in accs]}; path wall {wall:.2f} s "
          f"[{card}]", flush=True)
    return dict(counts=counts, feature_err=feat_err,
                flash_share=tally["share"], kernel_vs_local_rel=rel,
                accuracy=accs, features_ms=1e3 * feat_s, wall_s=wall,
                phase_s=time.perf_counter() - t_phase, kernel=kernel)


def personalize_kernel_timing(fed, card):
    """The SDCA kernel at the personalization federation's shape (8 tasks x
    72 rows x d 960: the wide-carry branch, r in shared memory), held
    against its plain version and timed beside its bound."""
    from repro_torch.kernels import sdca as K
    case = federation_case(fed)
    err = check_kernel("personalize federation 8 x 72 x 960 (wide carry)",
                       case, KERNEL_TOL)
    kernel = lambda: K.sdca_local_solve(**case)   # noqa: E731
    plain = lambda: K.sdca_ref(**_plain_args(case))   # noqa: E731
    for _ in range(3):
        kernel()
    ms = _events_ms(kernel, 50)
    device_ms = _device_ms_per_call(lambda c: K.sdca_local_solve(**c),
                                    [case], PROFILE_CALLS, ("sdca_kernel",))
    plain()
    plain_ms = _events_ms(plain, 3)
    b = bound(case)
    print(f"personalize timing [SDCA at 8 x 72 x 960 {b['mode']}]: kernel "
          f"{ms:.4f} ms/call (device {device_ms:.4f}), plain {plain_ms:.3f} "
          f"ms/call, bound {b['bound_ms']:.5f} ms ({b['bound_by']}) "
          f"[{card}]", flush=True)
    return dict(shape="m=8 n=72 d=960", mode=b["mode"], ms=ms,
                device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)


#: LM training: SmolLM-360M at full width, B 4 x S 512 from the TokenStream
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
#: step 0, kernel route vs plain route: ce and grad_norm relative, and the
#: layer-0 gradients of wq and w_down relative to their largest |g|.  The
#: two routes differ only in the flash kernel's forward, each of its calls
#: held to flash_tolerance on its own inputs (``held_flash_calls``); the
#: backward passes are the same plain recompute.  The limits are a few
#: times the readings on an H100 80GB HBM3 at 700 W (this script): f32 ce 0,
#: grad_norm 7.9e-8, gradients 1.1e-6 / 6.5e-7; bf16 ce 8.2e-5, grad_norm
#: 6.0e-5, gradients 7.3e-3 / 7.8e-3 (2^-7: one bf16 step at the leaf's
#: scale).  ``TRAIN_PLANTS`` are wrong flash routes the limits must fail.
TRAIN_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (5e-4, 3e-2)}
TRAIN_PLANTS = ("causal mask dropped", "causal mask dropped in the backward")


@contextlib.contextmanager
def planted_flash(plant):
    """A deliberately wrong flash route, to show that TRAIN_TOL fails it:
    the causal mask dropped in the kernel's forward and its recompute, or
    only in the backward's plain recompute (a fault the per-call forward
    check cannot see)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import layers
    if plant == TRAIN_PLANTS[0]:
        mod, name = layers, "flash_mha"
    else:
        mod, name = ops, "attention_ref"
    saved = getattr(mod, name)
    setattr(mod, name, lambda q, k, v, causal=True, window=None: saved(
        q, k, v, causal=False, window=window))
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _step0_readings(step0, plain, dtype):
    """(ce and grad_norm relative, layer-0 wq / w_down gradients of max|g|,
    whether both are within TRAIN_TOL) of a route against the plain one."""
    (g_k, m_k), (g_p, m_p) = step0, plain
    rel = {k: abs(m_k[k] - m_p[k]) / abs(m_p[k]) for k in ("ce", "grad_norm")}
    g_rel = [float((a.float() - b.float()).abs().max())
             / float(b.float().abs().max()) for a, b in zip(g_k, g_p)]
    rel_tol, g_tol = TRAIN_TOL[dtype]
    return rel, g_rel, max(rel.values()) <= rel_tol and max(g_rel) <= g_tol


def _train_run(dtype):
    """Step 0's gradients on the kernel route (every flash call held to
    flash_tolerance), the plain route and the planted routes, then
    TRAIN_STEPS AdamW steps on the kernel route (counters set to 0 just
    before, read just after)."""
    from repro_torch.data.tokens import DataConfig, TokenStream
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_grad_fn, make_train_step)
    model = _lm_model()
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    params, state = init_train_state(model, tc)
    batches = list(TokenStream(model.cfg, DataConfig(
        seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)).batches(TRAIN_STEPS))
    grad_fn = make_grad_fn(model, tc)

    def step0():
        g, m = grad_fn(params, batches[0])
        return ((g["blocks"][0]["attn"]["wq"], g["blocks"][0]["mlp"]["w_down"]),
                {k: float(v) for k, v in m.items()})

    tally = {}
    with held_flash_calls(tally, f"train {str(dtype)[6:]} step 0"):
        kernel0 = step0()
    with plain_attention():
        plain0 = step0()
    planted = {}
    for plant in TRAIN_PLANTS:
        with planted_flash(plant):
            planted[plant] = _step0_readings(step0(), plain0, dtype)
    step = make_train_step(model, tc)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    for b in batches:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))    # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = train_step_profile(lambda: step(params, state, batches[0]))
    return dict(losses=losses, counts=counts, step_ms=step_ms,
                peak_gb=peak_gb, profile=profile,
                step0=_step0_readings(kernel0, plain0, dtype),
                held=tally, planted=planted,
                n_params=sum(p.numel() for p in model.parameters()),
                flash_per_step=model.cfg.n_layers * (2 if model.cfg.remat
                                                     else 1))


def train_step_profile(step):
    """One more train step under torch.profiler: its wall, the device's
    busy time and kernels, the top kernels by device time and the flash
    kernel's share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    busy = sum(_device_ms(e) for e in events)
    top = sorted(events, key=lambda e: -_device_ms(e))[:6]
    flash = sum(_device_ms(e) for e in events
                if any(k in e.key for k in _PROFILE_KERNELS["flash"]))
    return dict(wall_ms=1e3 * wall, device_ms=busy,
                kernels=sum(e.count for e in events), flash_ms=flash,
                top=[(e.key[:50], e.count, _device_ms(e)) for e in top])


def phase_train():
    """LM training: SmolLM-360M at full width (random weights, seed 0), B 4
    x S 512 from the port's TokenStream, TRAIN_STEPS AdamW steps in float32
    and in bf16 with f32 master weights; step 0's ce, grad_norm and the
    layer-0 gradients of wq and w_down, kernel route vs plain route within
    TRAIN_TOL, each of step 0's 64 flash calls (the forward's 32, and
    ``cfg.remat``'s recompute of every block in the backward) within
    flash_tolerance of the plain version on its inputs, and each of
    TRAIN_PLANTS outside TRAIN_TOL; the loss falls; 64 flash launches a
    step."""
    card = card_line()
    out, launches = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        r = _train_run(dtype)
        name = str(dtype)[6:]
        rel_tol, g_tol = TRAIN_TOL[dtype]
        rel, g_rel, within = r["step0"]
        want = {"flash_attention": r["flash_per_step"] * TRAIN_STEPS,
                "decode_attention": 0, "sdca_local_solve": 0,
                "cache_attention": 0}
        if r["counts"] != want:
            raise AssertionError(f"train {name}: launches {r['counts']}, "
                                 f"expected {want}")
        if r["held"].get("calls") != r["flash_per_step"] or not within:
            raise AssertionError(f"train {name}: step 0 kernel vs plain "
                                 f"route {rel}, gradients {g_rel}, flash "
                                 f"calls held {r['held']}")
        for plant, (p_rel, p_g, p_within) in r["planted"].items():
            if p_within:
                raise AssertionError(f"train {name}: the planted fault "
                                     f"({plant}) passes TRAIN_TOL: {p_rel},"
                                     f" gradients {p_g}")
        losses = r["losses"]
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: the loss did not fall: "
                                 f"{losses}")
        launches += r["counts"]["flash_attention"]
        ms = float(np.mean(r["step_ms"][1:]))
        row = dict(losses=losses, step_ms=r["step_ms"], ms_per_step=ms,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                   peak_gb=r["peak_gb"], step0_rel=rel, grad_rel=g_rel,
                   flash_share=r["held"]["share"],
                   planted={k: dict(rel=v[0], grad_rel=v[1])
                            for k, v in r["planted"].items()},
                   launches=r["counts"]["flash_attention"])
        out[name] = row
        print(f"train [{ARCH} full width, {r['n_params'] / 1e6:.1f}M params,"
              f" {name}{' + f32 masters' if dtype != torch.float32 else ''},"
              f" B{TRAIN_BATCH} x S{TRAIN_SEQ}, AdamW]: loss "
              f"{[round(x, 4) for x in losses]}; step 0 kernel vs plain "
              f"route ce {rel['ce']:.2e}, grad_norm {rel['grad_norm']:.2e} "
              f"(tolerance {rel_tol:g}), layer-0 wq / w_down gradients "
              f"{g_rel[0]:.2e} / {g_rel[1]:.2e} of max|g| (tolerance "
              f"{g_tol:g}), {r['held']['calls']} flash calls within "
              f"flash_tolerance (largest share {r['held']['share']:.3f}); "
              + "".join(f"planted ({k}): ce {v[0]['ce']:.2e}, grad_norm "
                        f"{v[0]['grad_norm']:.2e}, gradients {v[1][0]:.2e} / "
                        f"{v[1][1]:.2e}, fails the limits; "
                        for k, v in r["planted"].items())
              + f"{ms:.1f} ms/step (steps 1-{TRAIN_STEPS - 1}; "
              f"step 0 {r['step_ms'][0]:.1f}), {row['tokens_per_s']:.0f} "
              f"tokens/s, peak {r['peak_gb']:.2f} GiB, flash launches "
              f"{row['launches']} [{card}]", flush=True)
        prof = row["profile"] = r["profile"]
        print(f"train profile [{name}, one step]: wall "
              f"{prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_ms']:.1f} ms "
              f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
              f"{prof['kernels']} device kernels, flash kernel "
              f"{prof['flash_ms']:.3f} ms; top by device time: "
              + "; ".join(f"{k} x{c} {ms:.2f} ms" for k, c, ms in
                          prof["top"]) + f" [{card}]", flush=True)
    return dict(runs=out, launches=launches)


#: ``phase_remat``'s case: rwkv6-7b at full width, 2 of its 32 layers,
#: one 4,096-token row (train_4k's row a device on pod16x16), bf16 with
#: f32 masters
REMAT_CASE = ("rwkv6-7b", 2, 1, 4096, torch.bfloat16)


def _remat_step(cfg, b, s, dtype):
    """Step 0's gradients and metrics of ``cfg`` on the card, and the
    step's peak above the parameters and optimizer state (GiB)."""
    from repro_torch.examples.sharded_lm import mesh_batch
    from repro_torch.models import build_model
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_grad_fn)
    from repro_torch.train.optimizer import tree_leaves
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    model = build_model(cfg, device=DEV, seed=0)
    params, _ = init_train_state(model, tc)
    batch = mesh_batch(cfg, b, s, 7, torch.device(DEV))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads, metrics = make_grad_fn(model, tc)(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    out = ([g.float().cpu() for g in tree_leaves(grads)],
           {k: float(v) for k, v in metrics.items()}, peak, wall)
    del model, params, grads
    torch.cuda.empty_cache()
    return out


def phase_remat():
    """``cfg.remat`` on one card at full width (REMAT_CASE): the train
    step's gradients with each block recomputed in the backward against
    the step without (``remat=False``; rwkv6's wkv chunks are recomputed
    in both), ce and grad_norm within TRAIN_TOL's relative limit, every
    gradient leaf within its limit of the leaf's max|g|; both steps'
    peaks above the parameters and optimizer state
    (``max_memory_allocated``) and walls."""
    from repro_torch.examples.sharded_lm import mesh_cfg
    arch, depth, b, s, dtype = REMAT_CASE
    cfg = mesh_cfg(arch, depth)
    if not cfg.remat:
        raise AssertionError(f"{arch} does not set remat")
    g1, m1, peak1, wall1 = _remat_step(cfg, b, s, dtype)
    g0, m0, peak0, wall0 = _remat_step(dataclasses.replace(cfg, remat=False),
                                       b, s, dtype)
    rel_tol, g_tol = TRAIN_TOL[dtype]
    rel = {k: abs(m1[k] - m0[k]) / abs(m0[k]) for k in ("ce", "grad_norm")}
    g_rel = max(float((a - c).abs().max()) / max(float(c.abs().max()),
                                                 1e-30)
                for a, c in zip(g1, g0))
    ok = max(rel.values()) <= rel_tol and g_rel <= g_tol and all(
        bool(torch.isfinite(a).all()) for a in g1)
    print(f"remat [{arch} full width, {depth} layers, "
          f"{str(dtype)[6:]} + f32 masters, B{b} x S{s}]: remat against "
          f"no remat ce {rel['ce']:.2e}, grad_norm {rel['grad_norm']:.2e} "
          f"(tolerance {rel_tol:g}), gradients {g_rel:.2e} of max|g| "
          f"(tolerance {g_tol:g}); step peak above the state: remat "
          f"{peak1:.3f} GiB, no remat {peak0:.3f} GiB; wall {wall1:.2f} / "
          f"{wall0:.2f} s [{card_line()}] {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"remat {arch}: {rel}, gradients {g_rel}")
    return dict(arch=arch, layers=depth, batch=b, seq=s, rel=rel,
                grad_rel=g_rel, peak_gib=peak1, peak_gib_no_remat=peak0,
                wall_s=wall1, wall_s_no_remat=wall0)


# ---------------------------------------------------------------------------
# the other model families at their published widths
# ---------------------------------------------------------------------------

#: (arch, layers run (None: all), batch, prompt tokens (vlm: text after the
#: image embeds; audio: frames of n_codebooks tokens)), random weights from
#: seed 0.  Depth is cut only where the f32 weights and their bf16 copy
#: would not fit the card: mixtral-8x7b's 32 layers are 280 GB, its 4 are
#: ~35 GB.  Prompts are multiples of 64 (WKV_CHUNK, ssm_chunk), so the
#: chunked scans never fall back to one chunk of S; mixtral's 4096 fills its
#: 4096-slot ring (S == T) and its 16 new tokens wrap it.
FAMILIES = (("mixtral-8x7b", 4, 1, 4096),
            ("granite-moe-1b-a400m", None, 2, 256),
            ("llava-next-mistral-7b", None, 1, 128),
            ("musicgen-medium", None, 2, 256),
            ("rwkv6-7b", None, 2, 256),
            ("zamba2-7b", None, 2, 256))
FAMILY_NEW = 16


def family_model(arch, depth):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    return build_model(cfg, device=DEV, seed=SEED)


def family_batch(cfg, b, prompt):
    """The family's prompt batch, from seed 0: tokens (B, S) (audio: (B, S,
    C)); vlm also ``frontend_tokens`` image embeddings (B, P, D)."""
    rng = np.random.default_rng(SEED)
    shape = (b, prompt, cfg.n_codebooks) if cfg.family == "audio" else (
        b, prompt)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).to(DEV)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).to(DEV)
    return batch


def attention_calls(model):
    """Flash launches a forward (decode launches a step): the attention
    blocks, the hybrid's shared-block calls, none for rwkv6."""
    cfg = model.cfg
    if cfg.block_type == "attention":
        return cfg.n_layers
    return model.n_periods


def family_forced_logits(model, batch, forced, dtype, max_len):
    """``Engine.generate``'s logits with the decode steps fed ``forced``
    (B, NEW) (audio: (B, NEW, C)) instead of their own greedy choices."""
    b = batch["tokens"].shape[0]
    cache = model.init_cache(b, max_len, dtype=dtype)
    logits, cache = model.prefill(batch, cache, dtype=dtype)
    seen = [logits]
    for i in range(forced.shape[1] - 1):
        tok = torch.from_numpy(np.ascontiguousarray(forced[:, i])).to(
            DEV, torch.int32)
        logits, cache = model.decode_step(tok, cache, dtype=dtype)
        seen.append(logits)
    return torch.stack(seen, dim=1)


def check_ring(model, batch, tokens, max_len):
    """mixtral's ring: prefill fills its T slots, each decode step writes
    slot pos % T.  The steps (fed ``tokens``) against one full-sequence
    forward over the same prompt + NEW tokens with the window (f32, kernel
    route).  Both route every token (capacity factor E / k), so a token the
    prefill's capacity drops and the longer forward keeps cannot differ."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                    / cfg.top_k)
    try:
        steps = family_forced_logits(model, batch, tokens, torch.float32,
                                     max_len)
        seq = torch.cat([batch["tokens"], torch.from_numpy(tokens).to(DEV)],
                        dim=1)
        full, aux = model.apply({"tokens": seq})
    finally:
        model.cfg = cfg
    s = batch["tokens"].shape[1]
    want = full[:, s - 1:s - 1 + tokens.shape[1]]
    scale = max(1.0, float(want.abs().max()))
    err = float((steps - want).abs().max())
    past = float((steps[:, 1:] - want[:, 1:]).abs().max())
    ok = err <= LOGIT_TOL[torch.float32] * scale and \
        float(aux["moe_drop_frac"]) == 0.0
    print(f"families [{cfg.name} ring]: T {min(cfg.sliding_window, max_len)}"
          f" slots, prefill {s} + {tokens.shape[1] - 1} decode steps "
          f"(positions {s}..{s + tokens.shape[1] - 2}) against the windowed "
          f"forward over {seq.shape[1]} tokens: max abs err {err:.3e} "
          f"(steps past the ring's end {past:.3e}; tolerance "
          f"{LOGIT_TOL[torch.float32]:g} x {scale:.3g}), dropped "
          f"{float(aux['moe_drop_frac']):g} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{cfg.name}: the ring's decode steps differ "
                             f"from the windowed forward")
    return err


def phase_families():
    """Each other family at its published widths through Engine.generate,
    f32 and bf16: the kernel route with the launch counters set to 0 just
    before each generate and read just after (flash: the attention calls a
    forward; decode: NEW - 1 times that), then the plain route on the card
    fed the kernel route's tokens, logits within LOGIT_TOL and greedy
    tokens equal in f32; the kernel route once more with each flash and
    decode call held against its plain version on its own inputs
    (``held_flash_calls``, ``held_decode_calls``); mixtral's wrapped ring
    against the windowed forward.  The card is freed between families."""
    import gc
    from repro_torch.examples.sharded_lm import moe_routing, routing_flips
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, ServeConfig
    out = {"flash_attention": 0, "decode_attention": 0, "runs": {}}
    for arch, depth, b, prompt in FAMILIES:
        t0 = time.perf_counter()
        model = family_model(arch, depth)
        cfg = model.cfg
        batch = family_batch(cfg, b, prompt)
        prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
        max_len = prefix + prompt + FAMILY_NEW + 8
        calls = attention_calls(model)
        want = {"flash_attention": calls,
                "decode_attention": calls * (FAMILY_NEW - 1),
                "sdca_local_solve": 0, "cache_attention": 0}
        n_params = sum(p.numel() for p in model.parameters())
        cut = ("" if depth is None else
               f", {depth} of {get_config(arch).n_layers} layers")
        what = f"B{b} prompt {prefix + prompt}" + (
            f" ({prefix} image embeds)" if prefix else "")
        runs, tokens_f32 = {}, None
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            eng = Engine(model, ServeConfig(max_len=max_len,
                                            max_new_tokens=FAMILY_NEW,
                                            cache_dtype=dtype))
            routes_k, routes_p = [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all_counts()
            t1 = time.perf_counter()
            with moe_routing(record=routes_k):
                tok_k, lg_k = eng.generate(batch, return_logits=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if counts != want:
                raise AssertionError(f"{arch} {name}: launches {counts}, "
                                     f"expected {want}")
            # the kernel route again, outside the counted run, each flash
            # and decode call held against its plain version on its inputs
            held_f, held_d = {}, {}
            if calls:
                with held_flash_calls(held_f, f"{arch} {name}"), \
                        held_decode_calls(held_d, f"{arch} {name}"):
                    eng.generate(batch, return_logits=True)
                if (held_f["calls"], held_d["calls"]) != (
                        want["flash_attention"], want["decode_attention"]):
                    raise AssertionError(f"{arch} {name}: held {held_f} "
                                         f"{held_d}, expected {want}")
            held = (f"; each call held against its plain version: flash "
                    f"{held_f.get('calls', 0)} (largest share of "
                    f"flash_tolerance {held_f.get('share', 0.0):.3f}), "
                    f"decode {held_d.get('calls', 0)} (largest share of "
                    f"attention_tolerance {held_d.get('share', 0.0):.3f})")
            reset_all_counts()
            with plain_attention():
                with moe_routing(record=routes_p):
                    lg_p = family_forced_logits(model, batch, tok_k, dtype,
                                                max_len)
                routed = ""
                if cfg.is_moe and dtype == torch.bfloat16:
                    # the plain route on the kernel route's experts; its own
                    # choices are reported beside it, not held
                    free = float((lg_k - lg_p).float().abs().max())
                    flips = routing_flips(routes_k, routes_p)
                    with moe_routing(replay=routes_k):
                        lg_p = family_forced_logits(model, batch, tok_k,
                                                    dtype, max_len)
                    routed = (f"; the plain route on the kernel route's "
                              f"experts (on its own: {flips} of "
                              f"{sum(len(r) for r in routes_k)} token "
                              f"choices differ, max abs err {free:.3e}, not "
                              f"held)")
            if any(read_counts().values()):
                raise AssertionError(f"the plain route launched a kernel: "
                                     f"{read_counts()}")
            vocab = ((cfg.n_codebooks, cfg.vocab_size) if cfg.family ==
                     "audio" else (cfg.vocab_size,))
            if lg_k.shape != (b, FAMILY_NEW) + vocab or \
                    not torch.isfinite(lg_k).all():
                raise AssertionError(f"{arch} logits {tuple(lg_k.shape)} "
                                     f"not finite or of the wrong shape")
            scale = max(1.0, float(lg_p.float().abs().max()))
            err = float((lg_k - lg_p).float().abs().max())
            same = bool(np.array_equal(
                tok_k, torch.argmax(lg_p, dim=-1).cpu().numpy()))
            tol = LOGIT_TOL[dtype] * scale
            print(f"families [{arch}{cut} {name}, {what} + {FAMILY_NEW} "
                  f"new, {n_params / 1e9:.3f} B params]: "
                  f"launches {counts}; logits kernel vs plain (fed the "
                  f"kernel route's tokens) max abs err {err:.3e} (tolerance "
                  f"{LOGIT_TOL[dtype]:g} x {scale:.3g}){routed}{held}; "
                  f"greedy tokens equal: {same}; wall generate {wall:.3f} "
                  f"s; peak {peak:.2f} GiB [{card_line()}]", flush=True)
            if err > tol:
                raise AssertionError(f"{arch} {name}: logits of the kernel "
                                     f"route differ from the plain route")
            if dtype == torch.float32:
                tokens_f32 = tok_k
                if not same:
                    raise AssertionError(f"{arch}: greedy tokens differ in "
                                         f"float32")
            runs[name] = dict(counts=counts, err=err, wall_s=wall,
                              peak_gib=peak, tokens_equal=same,
                              flash_share=held_f.get("share"),
                              decode_share=held_d.get("share"))
            for k in ("flash_attention", "decode_attention"):
                out[k] += counts[k]
        if cfg.sliding_window is not None:
            runs["ring_err"] = check_ring(model, batch, tokens_f32, max_len)
        out["runs"][arch] = dict(runs, layers=cfg.n_layers, batch=b,
                                 prompt=prefix + prompt,
                                 params=n_params,
                                 wall_s=time.perf_counter() - t0)
        del model, eng, lg_k, lg_p
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: ``phase_cache_segments``: SmolLM-360M's main-path prompt (B 8 x 1024)
#: in SEG_CALLS prefill calls, then SEG_NEW decode steps; mixtral-8x7b at
#: the families phase's 4 of 32 layers, B 1: a prompt filling its 4,096-
#: slot ring then a segment into it, and a prompt 1.5 x the ring; zamba2-7b
#: at 7 of 81 layers (one period of six mamba2 blocks with the shared
#: attention block, and a tail block), B 2: a prompt then a continuation
SEG_CALLS, SEG_NEW = 4, 32
SEG_MAX_LEN = PROMPT + SEG_NEW + 8
SEG_RING = ("mixtral-8x7b", 4, 4096, 256, 6144)
SEG_HYBRID = ("zamba2-7b", 7, 2, 256, 64)
SEG_BUDGET_S = 60.0


def _segmented(model, batch, dtype, calls, max_len, n_new=0, forced=None):
    """``batch`` in ``calls`` equal prefill calls on one cache, then
    ``n_new`` decode steps fed ``forced`` (B, n_new) (greedy where None):
    (the logits of each prefill call and decode step, (B, calls + n_new,
    ...), the tokens fed)."""
    from repro_torch.examples.sharded_lm import segment_batch
    b = batch["tokens"].shape[0]
    cache = model.init_cache(b, max_len, dtype=dtype)
    seen, fed = [], []
    for part in segment_batch(batch, calls):
        logits, cache = model.prefill(part, cache, dtype=dtype)
        seen.append(logits)
    for i in range(n_new):
        tok = (seen[-1].argmax(-1).to(torch.int32) if forced is None
               else forced[:, i])
        fed.append(tok)
        logits, cache = model.decode_step(tok, cache, dtype=dtype)
        seen.append(logits)
    return torch.stack(seen, dim=1), (torch.stack(fed, dim=1) if fed
                                      else None)


def _logit_err(label, got, want, dtype):
    """max |got - want| over max(1, max |want|), held to LOGIT_TOL."""
    err = float((got - want).float().abs().max()) / max(
        1.0, float(want.float().abs().max()))
    if not (torch.isfinite(got).all() and got.shape == want.shape
            and err <= LOGIT_TOL[dtype]):
        raise AssertionError(f"cache segments {label}: logits err {err:.3e} "
                             f"(limit {LOGIT_TOL[dtype]:g}), shapes "
                             f"{tuple(got.shape)} {tuple(want.shape)}")
    return err


def _seg_counts(label, counts, want):
    want = dict({"sdca_local_solve": 0, "flash_attention": 0,
                 "decode_attention": 0, "cache_attention": 0}, **want)
    if counts != want:
        raise AssertionError(f"cache segments {label}: launches {counts}, "
                             f"expected {want}")
    return counts


def phase_cache_segments():
    """A prompt continued in several ``Model.prefill`` calls on one cache
    (the JAX package's multi-turn / chunked prefill), at full width, random
    weights from seed 0, f32 and bf16; the launch counters set to 0 just
    before each kernel-route run and read just after, every cache_attention
    call of it held against its plain version on its own inputs
    (``held_cache_calls``; the plain version launches nothing).
    (a) SmolLM-360M, 32 layers, B 8: the 1,024-token prompt as four
    256-token calls (the first through flash, the others through the cache
    kernel), then SEG_NEW decode steps: logits against the one-shot
    prefill's fed the same tokens and against the plain route, f32 greedy
    tokens equal.  (b) mixtral-8x7b (4 of 32 layers), B 1: a 4,096-token
    prompt filling the ring, then a 256-token segment into the wrapped
    ring; (c) a 6,144-token prompt into the 4,096-slot ring; both against
    the plain route (bf16: on the kernel route's expert choices).  (d)
    zamba2-7b (7 of 81 layers), B 2: 256 then 64 tokens at head_dim 112,
    against the one-shot prefill and the plain route."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.examples.sharded_lm import moe_routing
    t0 = time.perf_counter()
    f32 = torch.float32
    out, held, launches = {}, {}, 0

    def kernel_route(label, fn, want):
        nonlocal launches
        reset_all_counts()
        with held_cache_calls(held, label):
            res = fn()
        torch.cuda.synchronize()
        counts = _seg_counts(label, read_counts(), want)
        launches += counts["cache_attention"]
        return res, counts

    def plain_route(fn):
        reset_all_counts()
        with plain_attention():
            res = fn()
        if any(read_counts().values()):
            raise AssertionError(f"the plain route launched a kernel: "
                                 f"{read_counts()}")
        return res

    # (a) SmolLM-360M
    model = _lm_model()
    cfg = model.cfg
    batch = {"tokens": _prompt(cfg.vocab_size)}
    n = cfg.n_layers
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        (lg_k, fed), counts = kernel_route(
            f"SmolLM {name}", lambda: _segmented(
                model, batch, dtype, SEG_CALLS, SEG_MAX_LEN, SEG_NEW),
            {"flash_attention": n, "cache_attention": (SEG_CALLS - 1) * n,
             "decode_attention": SEG_NEW * n})
        lg_1, _ = _segmented(model, batch, dtype, 1, SEG_MAX_LEN, SEG_NEW,
                             fed)
        lg_p, _ = plain_route(lambda: _segmented(
            model, batch, dtype, SEG_CALLS, SEG_MAX_LEN, SEG_NEW, fed))
        e1 = _logit_err(f"SmolLM {name} vs one-shot", lg_k[:, SEG_CALLS - 1:],
                        lg_1, dtype)
        ep = _logit_err(f"SmolLM {name} vs plain", lg_k, lg_p, dtype)
        same = bool(torch.equal(lg_1[:, :-1].argmax(-1), fed.long()))
        if dtype == f32 and not same:
            raise AssertionError("cache segments SmolLM: greedy tokens of "
                                 "the segmented and one-shot prefill differ")
        out[f"smollm_{name}"] = dict(counts=counts, err_one_shot=e1,
                                     err_plain=ep, tokens_equal=same)
        print(f"cache segments [{ARCH} {name}, B{BATCH} prompt {PROMPT} in "
              f"{SEG_CALLS} prefill calls + {SEG_NEW} decode steps]: "
              f"launches {counts}; logits vs the one-shot prefill (fed the "
              f"same tokens) {e1:.3e}, vs the plain route {ep:.3e} of "
              f"max(1, |logit|) (limit {LOGIT_TOL[dtype]:g}); greedy tokens "
              f"equal: {same}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (b), (c) mixtral-8x7b's ring
    arch, depth, ring, seg, long = SEG_RING
    model = family_model(arch, depth)
    cfg = model.cfg
    if cfg.sliding_window != ring:
        raise AssertionError(f"{arch}: window {cfg.sliding_window}")
    full = family_batch(cfg, 1, long)["tokens"]
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]
        for case, toks, calls, max_len, want in (
                ("b", full[:, :ring + seg], [ring, seg], ring + seg + 8,
                 {"flash_attention": depth, "cache_attention": depth}),
                ("c", full, [long], long + 8, {"cache_attention": depth})):
            def run(toks=toks, calls=calls, max_len=max_len):
                cache = model.init_cache(1, max_len, dtype=dtype)
                seen, at = [], 0
                for s_ in calls:
                    lg, cache = model.prefill(
                        {"tokens": toks[:, at:at + s_]}, cache, dtype=dtype)
                    seen.append(lg)
                    at += s_
                return torch.stack(seen, dim=1)
            routes = []
            with moe_routing(record=routes):
                lg_k, counts = kernel_route(f"{arch} ({case}) {name}", run,
                                            want)
            with moe_routing(replay=routes) if dtype != f32 else \
                    moe_routing(record=[]):
                lg_p = plain_route(run)
            err = _logit_err(f"{arch} ({case}) {name}", lg_k, lg_p, dtype)
            out[f"mixtral_{case}_{name}"] = dict(counts=counts, err=err)
            what = (f"a {ring}-token prompt filling the {ring}-slot ring, "
                    f"then {seg} tokens into the wrapped ring"
                    if case == "b" else
                    f"a {long}-token prompt into the {ring}-slot ring")
            print(f"cache segments [{arch} ({depth} of "
                  f"{get_config(arch).n_layers} layers) {name}, B1 ({case}) "
                  f"{what}]: launches {counts}; logits kernel vs plain route"
                  + (" (on the kernel route's experts)" if dtype != f32
                     else "") + f" {err:.3e} of max(1, |logit|) (limit "
                  f"{LOGIT_TOL[dtype]:g})", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) zamba2-7b's shared attention at head_dim 112
    arch, depth, b, first, second = SEG_HYBRID
    model = family_model(arch, depth)
    batch = family_batch(model.cfg, b, first + second)
    calls = model.n_periods
    max_len = first + second + 8
    for dtype in (f32, torch.bfloat16):
        name = str(dtype)[6:]

        def run(parts, dtype=dtype):
            cache = model.init_cache(b, max_len, dtype=dtype)
            seen, at = [], 0
            for s_ in parts:
                lg, cache = model.prefill(
                    {"tokens": batch["tokens"][:, at:at + s_]}, cache,
                    dtype=dtype)
                seen.append(lg)
                at += s_
            return torch.stack(seen, dim=1)
        lg_k, counts = kernel_route(
            f"{arch} {name}", lambda: run((first, second)),
            {"flash_attention": calls, "cache_attention": calls})
        lg_p = plain_route(lambda: run((first, second)))
        lg_1 = run((first + second,))
        ep = _logit_err(f"{arch} {name} vs plain", lg_k, lg_p, dtype)
        e1 = _logit_err(f"{arch} {name} vs one-shot", lg_k[:, -1:], lg_1,
                        dtype)
        out[f"zamba2_{name}"] = dict(counts=counts, err_plain=ep,
                                     err_one_shot=e1)
        print(f"cache segments [{arch} ({depth} of "
              f"{get_config(arch).n_layers} layers, {calls} shared "
              f"attention call at head_dim {model.cfg.head_dim}) {name}, "
              f"B{b} {first} + {second} tokens]: launches {counts}; logits "
              f"vs the plain route {ep:.3e}, the last vs the one-shot "
              f"prefill {e1:.3e} of max(1, |logit|) (limit "
              f"{LOGIT_TOL[dtype]:g})", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"cache segments: {launches} cache_attention launches, each call "
          f"held against its plain version ({held['calls']} calls, largest "
          f"share of cache_tolerance {held['share']:.3f}); phase "
          f"{wall:.1f} s (budget {SEG_BUDGET_S:.0f} s) [{card_line()}]",
          flush=True)
    if held["calls"] != launches or launches == 0:
        raise AssertionError(f"cache segments: {held['calls']} calls held, "
                             f"{launches} launched")
    return dict(runs=out, launches=launches, held=held, wall_s=wall)


DRYRUN_BUDGET_S = 60.0


def phase_dryrun():
    """The launch plan (``repro_torch.launch.dryrun``) for the whole matrix,
    10 archs x 4 shapes x both production meshes, against this card's
    memory: (a) every record ok, one line per arch and mesh with the
    per-device GiB by part and the cases whose arguments fit the card;
    (b) for every case whose argument bytes fit the card's free memory,
    rank 0's shards of every params, optimizer, batch and cache leaf
    allocated on the card (``torch.empty`` of ``local_shape`` in the
    plan's dtype): the allocator's requested bytes must grow by the plan's
    argument bytes exactly, then they are freed; (c) the phase's wall,
    within ``DRYRUN_BUDGET_S``.  Records land in results/dryrun_torch/."""
    import io
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_case
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    gib = 2 ** 30
    records = {}
    for multi_pod in (False, True):
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                with contextlib.redirect_stdout(io.StringIO()):
                    rec = dryrun.run_case(arch, shape, multi_pod,
                                          force=True, device="cuda")
                if rec["status"] != "ok":
                    raise AssertionError(f"dry-run {arch} {shape}: "
                                         f"{rec['error']}")
                records[(arch, shape, multi_pod)] = rec
    plan_s = time.perf_counter() - t0
    for multi_pod in (False, True):
        for arch in ALL_ARCHS:
            recs = [records[(arch, s, multi_pod)] for s in SHAPES]
            cells = []
            for shape, rec in zip(SHAPES, recs):
                m = rec["memory"]
                cells.append(f"{shape} {m['argument_bytes'] / gib:.3f} ("
                             + " ".join(f"{p[0]} {m[p + '_bytes'] / gib:.3f}"
                                        for p in ("params", "optimizer",
                                                  "batch", "cache")) + ")")
            fit = sum(bool(r["fits_arguments"]) for r in recs)
            print(f"dryrun {arch} {recs[0]['mesh']}: GiB/device "
                  + "; ".join(cells) + f"; fit {fit}/{len(recs)}")
    allocated, skipped = 0, []
    t_alloc = time.perf_counter()
    for (arch, shape, multi_pod), rec in records.items():
        want = rec["memory"]["argument_bytes"]
        if want > free:
            skipped.append(f"{arch}/{shape}/{rec['mesh']}")
            continue
        mesh = make_production_mesh(multi_pod=multi_pod)
        case = build_case(arch, shape, mesh)
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        held = [torch.empty(sh.local_shape(t.shape, spec, mesh),
                            dtype=t.dtype, device="cuda")
                for tree, specs in zip(case["args"], case["in_specs"])
                for _, t, spec in sh.leaves_with_specs(tree, specs)]
        grown = (torch.cuda.memory_stats()["requested_bytes.all.current"]
                 - before)
        del held
        if grown != want:
            raise AssertionError(f"dry-run {arch} {shape} {rec['mesh']}: "
                                 f"allocated {grown} B, the plan {want} B")
        allocated += 1
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"dryrun: {len(records)} records ok, plan {plan_s:.2f} s; "
          f"{allocated} cases allocated exactly the plan's bytes "
          f"({time.perf_counter() - t_alloc:.2f} s; free {free / gib:.2f} "
          f"of {total / gib:.2f} GiB), over the free memory: "
          f"{skipped or 'none'}; phase {wall:.2f} s (budget "
          f"{DRYRUN_BUDGET_S:.0f} s)", flush=True)
    if wall > DRYRUN_BUDGET_S:
        raise AssertionError(f"dry-run phase {wall:.1f} s over its budget")
    return dict(records=len(records), allocated=allocated, skipped=skipped,
                plan_s=plan_s, wall_s=wall, free_bytes=free,
                device_memory_bytes=records[(ALL_ARCHS[0], "train_4k",
                                             False)]["device_memory_bytes"],
                max_argument_bytes=max(r["memory"]["argument_bytes"]
                                       for r in records.values()))


DRYRUN_COSTS_BUDGET_S = 90.0
#: one case a group of families, on pod16x16
DRYRUN_COST_CASES = (("smollm-360m", "train_4k"), ("mixtral-8x7b",
                                                   "decode_32k"),
                     ("rwkv6-7b", "train_4k"), ("zamba2-7b", "prefill_32k"))
#: cases of the card probe alone (temp bytes; no CPU probe): mixtral-8x7b
#: train_4k, whose expert products asked for 224 GiB before they were
#: computed as one bmm over E (PERF.md §6)
DRYRUN_CARD_ONLY = (("mixtral-8x7b", "train_4k"),)
#: smollm-360m train_4k's temp bytes differenced from two depths against a
#: full-depth run, relative: the step's live set grows by a layer's saved
#: activations a layer, and what is not linear in depth (the optimizer's
#: and the gradients' per-layer buffers freed and reused in another
#: order) is a few percent of it
DRYRUN_TEMP_RTOL = 0.10
#: the MOCHA round's one all-gather at the default sizes: m x d, f32 / bf16
MOCHA_GATHER_BYTES = {False: 512 * 561 * 4, True: 512 * 561 * 2}


def _same_collectives(label, fake, card):
    """The card's collectives (kernel route) against the fake probe's:
    equal by kind, in count and bytes."""
    keys = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "count")
    diff = {k: (fake[k], card[k]) for k in keys if fake[k] != card[k]}
    if diff:
        raise AssertionError(f"{label}: card against fake probe {diff}")


def dryrun_costs_run(out):
    """``phase_dryrun_costs``' body, in a process of its own (every probe
    makes a fake process group; none may live in the script's process):
    for ``DRYRUN_COST_CASES`` side by side, the CPU probes of
    ``roofline.measure_full_depth`` (two processes a case) and, beside
    them, one card probe (``probe.card_memory``) of every case at
    ``dryrun.card_depths`` and of smollm-360m train_4k at 32 layers; the
    MOCHA round at its default sizes in f32 and bf16; the checks, then
    the result as JSON in ``out``."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch import dryrun, mocha_dryrun, probe, roofline
    from repro_torch.launch.specs import resolve_arch_for_shape
    gib = 2 ** 30
    t0 = time.perf_counter()
    cfgs = [resolve_arch_for_shape(a, s)[0] for a, s in DRYRUN_COST_CASES]
    card_cases = [[a, s, dryrun.card_depths(cfg)]
                  for (a, s), cfg in zip(DRYRUN_COST_CASES, cfgs)]
    big = [c for c in card_cases if c[0] == "rwkv6-7b"]
    big.append(["smollm-360m", "train_4k", [32]])
    rest = [c for c in card_cases if c[0] != "rwkv6-7b"] + [
        [a, s, dryrun.card_depths(resolve_arch_for_shape(a, s)[0])]
        for a, s in DRYRUN_CARD_ONLY]
    with ThreadPoolExecutor(len(DRYRUN_COST_CASES) + 2) as pool:
        # beside the CPU's probes and the MOCHA rounds (4.7 GB), two card
        # processes from the start: rwkv6 (~7 GiB at 3 layers with remat;
        # 50 without it, when the others had to wait for the rounds), then
        # smollm's 32 layers (4.5 GiB); and the other cases (at most 8.9
        # GiB, mixtral's train step).  With the script's own ~6 GB that
        # fits the card's 79 GiB
        big = pool.submit(probe.spawn, "card_memory", cases=big)
        rest = pool.submit(probe.spawn, "card_memory", cases=rest)
        costs = [pool.submit(roofline.measure_full_depth, a, s)
                 for a, s in DRYRUN_COST_CASES]
        moch = {wire: mocha_dryrun.run(bf16_wire=wire)
                for wire in (False, True)}
        costs = [f.result() for f in costs]
        big, rest = big.result()["cases"], rest.result()["cases"]
        by_case = {(c["arch"], c["shape"]): c for c in big[:-1] + rest}
        card = [by_case[c] for c in DRYRUN_COST_CASES] + big[-1:]
        card_only = [by_case[c] for c in DRYRUN_CARD_ONLY]
    out_rec = {"cases": {}, "mocha": {}}
    launches = {"flash_attention": 0, "decode_attention": 0}
    for c in card + card_only:
        for d in c["depths"].values():
            if d["status"] != "ok":
                raise AssertionError(
                    f"card probe {c['arch']} {c['shape']}: " + "; ".join(
                        f"L{n} {v.get('error', 'ok')}"
                        for n, v in c["depths"].items()))
            for k in launches:
                launches[k] += d["launches"][k]
    for (arch, shape), cfg, cost, got in zip(DRYRUN_COST_CASES, cfgs, costs,
                                             card):
        tag = f"{arch} {shape}"
        for depth, fake in cost["probes"].items():
            _same_collectives(f"{tag} L{depth}", fake["collectives"],
                              got["depths"][depth]["collectives"])
        temp = dryrun.temp_from_depths(cfg, got["depths"])["temp_bytes"]
        coll = cost["collectives"]
        model = roofline.model_flops(cfg, shape) / roofline.CHIPS
        print(f"dryrun costs {tag} pod16x16: flops/device "
              f"{cost['flops']:.4e} bytes/device {cost['bytes']:.4e} "
              f"collectives {coll['total']:.4e} B ({coll['count']:.0f}: "
              + ", ".join(f"{k} {coll[k]:.3e}" for k in (
                  "all-gather", "reduce-scatter", "all-reduce", "all-to-all")
                  if coll[k]) + f") temp {temp / gib:.3f} GiB useful "
              f"{model / cost['flops']:.3f}; collectives at each depth equal "
              f"to the fake probe's", flush=True)
        out_rec["cases"][tag] = {
            "flops_device": cost["flops"], "bytes_device": cost["bytes"],
            "collectives": coll, "temp_bytes": temp,
            "model_flops_per_device": model,
            "card_depths": {d: {k: v[k] for k in ("temp_bytes", "step_s",
                                                  "launches")}
                            for d, v in got["depths"].items()}}
    memory = torch.cuda.get_device_properties(0).total_memory
    rwkv6 = out_rec["cases"]["rwkv6-7b train_4k"]["temp_bytes"]
    print(f"dryrun costs rwkv6-7b train_4k temp {rwkv6 / gib:.3f} GiB of "
          f"the card's {memory / gib:.2f} GiB", flush=True)
    if rwkv6 > memory:
        raise AssertionError(f"rwkv6-7b train_4k needs {rwkv6 / gib:.1f} "
                             f"GiB a device, over the card's memory")
    out_rec["card_only"] = {}
    for (arch, shape), got in zip(DRYRUN_CARD_ONLY, card_only):
        cfg = resolve_arch_for_shape(arch, shape)[0]
        temp = dryrun.temp_from_depths(cfg, got["depths"])["temp_bytes"]
        print(f"dryrun costs {arch} {shape} pod16x16 (card probe): temp "
              f"{temp / gib:.3f} GiB; at each depth " + ", ".join(
                  f"L{n} {d['temp_bytes'] / gib:.3f}"
                  for n, d in got["depths"].items()), flush=True)
        out_rec["card_only"][f"{arch} {shape}"] = {
            "temp_bytes": temp,
            "card_depths": {d: {k: v[k] for k in ("temp_bytes", "step_s",
                                                  "launches")}
                            for d, v in got["depths"].items()}}
    smollm = out_rec["cases"]["smollm-360m train_4k"]["temp_bytes"]
    full = card[-1]["depths"]["32"]["temp_bytes"]
    share = abs(smollm - full) / full
    print(f"dryrun costs smollm-360m train_4k temp: differenced "
          f"{smollm / gib:.4f} GiB, 32 layers run {full / gib:.4f} GiB "
          f"({share:.2%}, limit {DRYRUN_TEMP_RTOL:.0%})", flush=True)
    if share > DRYRUN_TEMP_RTOL:
        raise AssertionError(f"differenced temp bytes {share:.2%} from the "
                             f"full-depth run")
    for wire, rec in moch.items():
        coll, want = rec["collectives"], MOCHA_GATHER_BYTES[wire]
        if coll["count"] != 1 or coll["all-gather"] != want:
            raise AssertionError(f"MOCHA round (bf16 wire {wire}): "
                                 f"{coll}, want one all-gather of {want} B")
        out_rec["mocha"]["bf16" if wire else "f32"] = {
            k: rec[k] for k in ("memory", "cost", "collectives", "probe_s")}
    wall = time.perf_counter() - t0
    out_rec.update(launches=launches, wall_s=wall,
                   smollm_full_temp_bytes=full, smollm_temp_share=share)
    Path(out).write_text(json.dumps(out_rec))
    return 0


def phase_dryrun_costs():
    """The dry-run's compiler half (what ``repro_torch.launch.dryrun
    --costs`` records): in a process of its own (``chip_smoke.py
    --dryrun-costs``), for
    smollm-360m train_4k, mixtral-8x7b decode_32k, rwkv6-7b train_4k and
    zamba2-7b prefill_32k on pod16x16 (and mixtral-8x7b train_4k's temp
    bytes alone, ``DRYRUN_CARD_ONLY``), each a step as rank 0 of a fake
    256-rank group: FLOPs, bytes and collective bytes a device (the CPU
    probes on FakeTensors) and the temp bytes on the card (the kernel
    route on rank 0's real shards), both at two depths differenced to full
    depth; the card's collectives at each depth equal to the fake probe's
    by kind and bytes; smollm-360m's differenced temp bytes within
    ``DRYRUN_TEMP_RTOL`` of a full-depth run; rwkv6-7b train_4k's
    within the card's memory (``cfg.remat``); the MOCHA round at its
    default sizes (m 512, d 561), f32 and bf16 wire, one all-gather of
    ``MOCHA_GATHER_BYTES``; within ``DRYRUN_COSTS_BUDGET_S``; and no
    process group left in this process."""
    import tempfile
    t0 = time.perf_counter()
    torch.cuda.empty_cache()          # the card's memory for the probes
    with tempfile.TemporaryDirectory() as tdir:
        out = Path(tdir) / "costs.json"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-costs",
             str(out)], capture_output=True, text=True,
            timeout=4 * DRYRUN_COSTS_BUDGET_S)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"dry-run costs exited {proc.returncode}: "
                                 f"{(proc.stdout + proc.stderr)[-4000:]}")
        res = json.loads(out.read_text())
    wall = time.perf_counter() - t0
    if torch.distributed.is_initialized():
        raise AssertionError("a process group is left in the script's "
                             "process")
    print(f"dryrun costs: phase {wall:.2f} s (budget "
          f"{DRYRUN_COSTS_BUDGET_S:.0f} s); launches {res['launches']}",
          flush=True)
    if wall > DRYRUN_COSTS_BUDGET_S:
        raise AssertionError(f"dry-run costs phase {wall:.1f} s over its "
                             f"budget")
    res["phase_s"] = wall
    return res


# ---------------------------------------------------------------------------
# the sharded LM step on a 2 x 2 mesh of gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_TIMEOUT_S = 600
MESH_SEQ = 512
#: (arch, layers run (None: all), dtype, batch): MESH_TRAIN_STEPS AdamW
#: steps each; B 4 puts the batch over ('data', 'model'), B 2 over
#: ('data',) with the weights over 'model'.  SmolLM-360M runs 8 of its
#: 32 layers (16 from PR 24, 8 since the train steps recompute each
#: block: PERF.md §6), to keep the mesh phases within the script's time
MESH_TRAIN = (("smollm-360m", 8, torch.bfloat16, 4),
              ("smollm-360m", 8, torch.float32, 2))
MESH_TRAIN_STEPS = 2
#: (arch, layers run, batch, prompt, dtypes) of one generate each (vlm:
#: the text after the image embeds; audio: frames of n_codebooks tokens)
MESH_GEN = (("smollm-360m", 8, 8, 1024, (torch.float32, torch.bfloat16)),
            ("granite-3-2b", 20, 2, 256, (torch.bfloat16,)))
MESH_NEW = 8
#: ``phase_mesh_families``' runs, as MESH_TRAIN and MESH_GEN.  Depth is cut
#: only for the phase's time: mixtral-8x7b at 1 of 32 layers (1.6 B
#: params), llava at 2 of 32, granite-moe at 12 of 24 and musicgen at 24
#: of 48 (all of both until the train steps recomputed each block).
#: granite-moe trains at B 4 x 512 over ('data', 'model'): 4 routing
#: groups.
MESH_FAMILY_TRAIN = (("granite-moe-1b-a400m", 12, torch.bfloat16, 4),)
MESH_FAMILY_GEN = (
    ("granite-moe-1b-a400m", 12, 2, 256, (torch.float32, torch.bfloat16)),
    ("mixtral-8x7b", 1, 1, 4096, (torch.float32, torch.bfloat16)),
    ("musicgen-medium", 24, 2, 256, (torch.bfloat16,)),
    ("llava-next-mistral-7b", 2, 1, 128, (torch.bfloat16,)))
#: ``phase_mesh_recurrent``'s runs: depth cut only for the phase's time,
#: rwkv6-7b to 2 of 32 layers, zamba2-7b to 7 of 81 (one period of six
#: mamba2 blocks with its call of the shared attention block, and one tail
#: block; 13 layers, two shared calls, ran 79 s alone: PERF.md §6).
#: rwkv6 trains at B 4 over ('data', 'model') (each rank all 64 heads,
#: eight 64-token wkv chunks), zamba2 at B 2 over ('data',).
MESH_RECURRENT_TRAIN = (("rwkv6-7b", 2, torch.bfloat16, 4),
                        ("zamba2-7b", 7, torch.bfloat16, 2))
MESH_RECURRENT_GEN = (
    ("rwkv6-7b", 2, 2, 256, (torch.float32, torch.bfloat16)),
    ("zamba2-7b", 7, 2, 256, (torch.float32, torch.bfloat16)))
#: (arch, layers run, batch, prompt, segments, dtypes): a generate whose
#: prompt is prefilled in ``segments`` calls on one cache (the later ones
#: through the cache attention kernel, each rank on its T-slice)
MESH_SEGMENTED = (("smollm-360m", 8, 8, 1024, 4,
                   (torch.float32, torch.bfloat16)),)
MESH_PHASES = {"step": (MESH_TRAIN, MESH_GEN, MESH_SEGMENTED),
               "families": (MESH_FAMILY_TRAIN, MESH_FAMILY_GEN, ()),
               "recurrent": (MESH_RECURRENT_TRAIN, MESH_RECURRENT_GEN, ())}


def _gen_list(gens, segmented):
    """A phase's generates one (arch, layers, batch, prompt, dtype,
    segments) each: ``gens``' in one prefill call, then ``segmented``'s."""
    from repro_torch.examples.sharded_lm import gen_runs
    return ([(*run, 1) for run in gen_runs(gens)]
            + [(a, d, b, p, dt, n) for a, d, b, p, n, dts in segmented
               for dt in dts])

def _routes_of(ref, key):
    """The expert choices saved under ``key``_<call> in ``ref``, in call
    order (None where there are none)."""
    keys = sorted((k for k in ref if k.startswith(key + "_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [ref[k] for k in keys] or None


def mesh_rank(rank, store, tdir, phase):
    """One of MESH_RANKS gloo ranks on the one card (the mesh phases,
    spawned by ``chip_smoke.py --mesh-rank``): every train and generate
    run of ``MESH_PHASES[phase]`` on a 2 x 2 mesh through
    ``repro_torch.examples.sharded_lm``'s runs, the launch counters set to
    0 just before and read just after; rank 0 writes the results."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.examples.sharded_lm import (mesh_cfg, mesh_generate_run,
                                                 mesh_train_run)
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.utils.dist import gloo_collectives
    rank, dev = int(rank), torch.device(DEV)
    trains, gens, segmented = MESH_PHASES[phase]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, MESH_RANKS),
                            rank=rank, world_size=MESH_RANKS,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S // 2))
    mesh = make_test_mesh(2, 2)
    dm = device_mesh(mesh, device="cuda")
    ref = dict(np.load(f"{tdir}/ref.npz"))
    reset_all_counts()
    train, gen = [], []
    with gloo_collectives():
        for i, (arch, depth, dtype, b) in enumerate(trains):
            train.append(mesh_train_run(
                mesh_cfg(arch, depth), dtype, b, dev, mesh, dm,
                _routes_of(ref, f"routes_train_{i}"), seq=MESH_SEQ,
                steps=MESH_TRAIN_STEPS))
        for i, (arch, depth, b, prompt, dtype, n) in enumerate(
                _gen_list(gens, segmented)):
            gen.append(mesh_generate_run(
                mesh_cfg(arch, depth), b, prompt, dtype, dev, ref[f"fed_{i}"],
                mesh, dm, _routes_of(ref, f"routes_gen_{i}"), new=MESH_NEW,
                segments=n))
    counts = read_counts()
    launches = [None] * MESH_RANKS
    routing = [None] * MESH_RANKS
    dist.all_gather_object(launches, counts)
    dist.all_gather_object(routing, [r.get("routing") for r in train + gen])
    if rank == 0:
        np.savez(f"{tdir}/mesh.npz", **{f"logits_{i}": g.pop("logits")
                                        for i, g in enumerate(gen)})
        for g in gen:
            g.pop("fed")
        with open(f"{tdir}/mesh.json", "w") as f:
            json.dump(dict(train=train, gen=gen, launches=launches,
                           routing=routing), f)
    dist.destroy_process_group()
    return 0


def _spawn_mesh_ranks(tdir, phase):
    logs = [open(f"{tdir}/log.{r}", "w+") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler",
         str(Path(__file__).resolve()), "--mesh-rank", str(r),
         f"{tdir}/store", tdir, phase],
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(MESH_RANKS)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = []
    for r, p in enumerate(procs):
        logs[r].seek(0)
        log = logs[r].read()
        logs[r].close()
        if p.returncode != 0:
            failed.append(f"mesh rank {r} exited {p.returncode}: "
                          f"{log[-3000:]}")
    if failed:
        raise AssertionError("\n".join(failed))


def _mesh_phase(phase, label):
    """The runs of ``MESH_PHASES[phase]``: each on one device of the card
    first (inside the same ``activation_sharding`` context, no device
    mesh), then on MESH_RANKS gloo ranks sharing the card, spawned, and
    held as ``sharded_lm.train_row`` and ``generate_row`` hold them: ce
    and grad_norm within its TRAIN_RTOL, logits within its LOGIT_TOL of
    max(1, max |logit|), f32 greedy tokens equal; on each rank no decode
    step all-gathering a state or cache shard and every leaf in the plan's
    placements (a rank raises otherwise); flash and decode (and, with
    segmented runs, cache attention) launched on the ranks.  Prints walls,
    DTensor's collectives a step, MoE's routing flips by rank, and the
    launches of every rank."""
    import tempfile
    from repro_torch.examples.sharded_lm import (generate_row, mesh_cfg,
                                                 mesh_generate_run,
                                                 mesh_train_run, train_row)
    dev = torch.device(DEV)
    trains, gens, segmented = MESH_PHASES[phase]
    runs = _gen_list(gens, segmented)
    t0 = time.perf_counter()
    ref_train, ref_gen, saved = [], [], {}
    for i, (arch, depth, dtype, b) in enumerate(trains):
        one = mesh_train_run(mesh_cfg(arch, depth), dtype, b, dev,
                             seq=MESH_SEQ, steps=MESH_TRAIN_STEPS)
        for j, r in enumerate(one.pop("routes", [])):
            saved[f"routes_train_{i}_{j}"] = r
        ref_train.append(one)
    for i, (arch, depth, b, prompt, dtype, n) in enumerate(runs):
        one = mesh_generate_run(mesh_cfg(arch, depth), b, prompt, dtype, dev,
                                new=MESH_NEW, segments=n)
        saved[f"fed_{i}"] = one["fed"]
        for j, r in enumerate(one.pop("routes", [])):
            saved[f"routes_gen_{i}_{j}"] = r
        ref_gen.append(one)
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tdir:
        np.savez(f"{tdir}/ref.npz", **saved)
        t1 = time.perf_counter()
        _spawn_mesh_ranks(tdir, phase)
        spawn_s = time.perf_counter() - t1
        with open(f"{tdir}/mesh.json") as f:
            got = json.load(f)
        logits = dict(np.load(f"{tdir}/mesh.npz"))
    report = dict(ranks=MESH_RANKS, mesh="2x2 (data, model)",
                  one_device_s=ref_s, ranks_s=spawn_s, train=[], generate=[])
    routing = [[r[i] for r in got["routing"]]
               for i in range(len(trains) + len(runs))]
    for i, ((arch, depth, dtype, b), one, mesh) in enumerate(
            zip(trains, ref_train, got["train"])):
        row, ok, line = train_row(arch, mesh_cfg(arch, depth), dtype, b,
                                  MESH_SEQ, one, mesh, routing[i])
        report["train"].append(row)
        print(f"{label} {line}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {line}")
    for i, (arch, depth, b, prompt, dtype, n) in enumerate(runs):
        row, ok, line = generate_row(
            arch, mesh_cfg(arch, depth), dtype, b, prompt, MESH_NEW,
            ref_gen[i], got["gen"][i], logits[f"logits_{i}"],
            routing[len(trains) + i], segments=n)
        report["generate"].append(row)
        print(f"{label} {line}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {line}")
    used = ("flash_attention", "decode_attention") + (
        ("cache_attention",) if segmented else ())
    report["launches"] = {k: sum(c[k] for c in got["launches"])
                          for k in used}
    report["launches_by_rank"] = got["launches"]
    report["wall_s"] = time.perf_counter() - t0
    if min(report["launches"].values()) == 0:
        raise AssertionError(f"{label}: a kernel was not launched: "
                             f"{report['launches']}")
    print(f"{label}: launches over {MESH_RANKS} ranks "
          f"{report['launches']}, phase {report['wall_s']:.1f} s "
          f"(one device {ref_s:.1f}, ranks {spawn_s:.1f}) [{card_line()}]",
          flush=True)
    return report


def phase_mesh_step():
    """The sharded LM step (``launch.specs.build_case``'s ``fn`` on DTensor
    parameters, optimizer state, batch and cache) on a 2 x 2 mesh of
    MESH_RANKS gloo ranks sharing the card (spawned ``chip_smoke.py
    --mesh-rank``), the dense family: SmolLM-360M at full width (8 of
    32 layers), MESH_TRAIN_STEPS AdamW steps in bf16 with f32 masters at
    B 4 x 512 (batch over ('data', 'model')) and in f32 at B 2 x 512
    (over ('data',)); one generate (prefill, then MESH_NEW - 1 decode
    steps) of SmolLM-360M at B 8, prompt 1024, f32 and bf16, and of
    granite-3-2b (20 of 40 layers) at B 2, prompt 256, bf16 (heads split
    over 'model'), the decode steps fed the one-device run's tokens; and
    SmolLM-360M's generate again with its prompt in four prefill calls on
    one cache (MESH_SEGMENTED: each later call writes into each rank's
    T-slice and reads it through the cache attention kernel, merged by
    the slices' log-sum-exps); held as ``_mesh_phase`` holds them."""
    return _mesh_phase("step", "mesh step")


def phase_mesh_families():
    """``phase_mesh_step`` for the attention-block families past the dense
    one and the window's ring (MESH_FAMILY_TRAIN, MESH_FAMILY_GEN), at full
    width, random weights from seed 0: granite-moe-1b-a400m (12 of 24
    layers, 32 experts, top-8) two bf16 AdamW steps with f32 masters at B
    4 x 512 (batch over
    ('data', 'model'): 4 routing groups) and a generate of B 2 x 256 + 8
    in f32 and bf16; mixtral-8x7b (1 of 32 layers) B 1 x 4096 + 8, f32 and
    bf16, the prompt filling the 4096-slot ring (2,048 a rank) and each
    decode step overwriting its oldest slot; musicgen-medium (24 of 48
    layers) B 2 x 256 frames + 8, bf16; llava-next-mistral-7b (2 of 32 layers) B 1 x (1,152
    image embeds + 128 text) + 8, bf16.  Each run is held against the
    same run on one device under the same ``activation_sharding`` context
    (MoE in as many groups); in bf16 MoE on the one-device run's expert
    choices, replayed on each rank's groups (``rank_routing``), its own
    flips counted in both dtypes."""
    from repro_torch.examples.sharded_lm import mesh_cfg
    report = _mesh_phase("families", "mesh families")
    for r in report["generate"]:
        window = mesh_cfg(r["arch"], r["layers"]).sliding_window
        if window is not None and (r["prompt"] != window or r[
                "cache_slots"] != [window, window // 2]):
            raise AssertionError(f"{r['arch']}: the prompt does not fill "
                                 f"the ring: {r}")
    return report


def phase_mesh_recurrent():
    """``phase_mesh_step`` for the recurrent families (MESH_RECURRENT_TRAIN,
    MESH_RECURRENT_GEN), at full width, random weights from seed 0:
    rwkv6-7b (2 of 32 layers) two bf16 AdamW steps with f32 masters at B 4
    x 512 (batch over ('data', 'model'): each rank all 64 heads, eight
    64-token wkv chunks) and a generate of B 2 x 256 + 8 in f32 and bf16
    (batch over 'data', the 64 heads and the wkv state S over 'model');
    zamba2-7b (7 of 81 layers: a period of six mamba2 blocks followed by
    the shared attention block, and one tail block) two bf16
    steps at B 2 x 512 (the 112 SSM heads and the shared block's 32
    attention heads over 'model') and a generate of B 2 x 256 + 8 in f32
    and bf16 (flash at head_dim 112 on each rank's 16 heads, decode over
    each rank's T-slice of each call's cache).  Each run is held against
    the same run on one device under the same ``activation_sharding``
    context, as ``_mesh_phase`` holds them, the states in the plan's
    placements after prefill and every decode step."""
    return _mesh_phase("recurrent", "mesh recurrent")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase_build()
    errs = phase_kernels()
    attn_errs = phase_attention_kernels()
    main_runs = phase_main_path()
    launches = sum(r["launches"] for r in main_runs.values())
    eval_path = phase_eval_path()
    eval_launches = (eval_path["grids"]["kernel_grid_launches"]
                     + eval_path["grids"]["global_launches"])
    cohort = phase_cohort_path()
    serve_tier = phase_serve_tier()
    sharded = phase_sharded_path()
    phase_small_reference()
    lm = phase_lm_main_path()
    phase_lm_small_reference()
    pers = phase_personalize()
    train = phase_train()
    remat = phase_remat()
    families = phase_families()
    segments = phase_cache_segments()
    dry = phase_dryrun()
    dry_costs = phase_dryrun_costs()
    shapes = phase_timing(main_runs, errs)
    phase_profile(main_runs)
    attn = phase_attention_timing(attn_errs)
    cache_rows = phase_cache_timing(attn_errs)
    serve = phase_serve_timing(lm)
    phase_lm_profile(lm)
    cohort["profile"] = phase_cohort_profile()
    eval_path["replay_profile"] = phase_eval_profile(eval_path["drivers"])
    # last: their four extra processes on the card perturb no timing
    mesh_step = phase_mesh_step()
    mesh_families = phase_mesh_families()
    mesh_recurrent = phase_mesh_recurrent()
    head = shapes["vehicle_sensor"]
    shapes["cohort_k256"] = dict(cohort["kernel"],
                                 max_abs_err=errs["cohort"])
    shapes["personalize_d960"] = pers["kernel"]
    sdca_paths = {"mocha_main": launches, "eval_kernel_grids": eval_launches,
                  "cohort": cohort["launches"],
                  "serve": serve_tier["launches"],
                  "personalize": pers["counts"]["sdca_local_solve"]}
    flash_paths = {"lm_generate": sum(lm[dt]["counts"]["flash_attention"]
                                      for dt in ("float32", "bfloat16")),
                   "personalize": pers["counts"]["flash_attention"],
                   "train": train["launches"],
                   "families": families["flash_attention"],
                   "sharded_lm_1x1":
                       sharded["lm_1x1"]["launches"]["flash_attention"],
                   "mesh_step": mesh_step["launches"]["flash_attention"],
                   "mesh_families":
                       mesh_families["launches"]["flash_attention"],
                   "mesh_recurrent":
                       mesh_recurrent["launches"]["flash_attention"],
                   "dryrun_costs": dry_costs["launches"]["flash_attention"]}
    decode_paths = {"lm_generate": sum(lm[dt]["counts"]["decode_attention"]
                                       for dt in ("float32", "bfloat16")),
                    "families": families["decode_attention"],
                    "sharded_lm_1x1":
                        sharded["lm_1x1"]["launches"]["decode_attention"],
                    "mesh_step": mesh_step["launches"]["decode_attention"],
                    "mesh_families":
                        mesh_families["launches"]["decode_attention"],
                    "mesh_recurrent":
                        mesh_recurrent["launches"]["decode_attention"],
                    "dryrun_costs":
                        dry_costs["launches"]["decode_attention"]}
    kernels = [dict(
        name="sdca_local_solve", route="cuda",
        source="src/repro_torch/kernels/sdca/csrc/sdca.cu",
        replaces="src/repro/kernels/sdca/sdca.py:45",
        launches=sum(sdca_paths.values()), launches_by_path=sdca_paths,
        max_abs_err=max(*errs.values(), pers["kernel"]["max_abs_err"]),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        shapes=shapes)]
    for name, counter, source, replaces, paths in (
            ("flash", "flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:27",
             flash_paths),
            ("decode", "decode_attention",
             "src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:24",
             decode_paths)):
        f32, bf16 = attn[(name, "float32")], attn[(name, "bfloat16")]
        kernels.append(dict(
            name=counter, route="cuda", source=source, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=max(f32["max_abs_err"], bf16["max_abs_err"]),
            ms=f32["ms"], plain_ms=f32["plain_ms"],
            bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
            library_ms=f32["library_ms"],
            shapes={"float32": f32, "bfloat16": bf16,
                    "zamba2_float32": attn[(name, "float32", "zamba2")],
                    "zamba2_bfloat16": attn[(name, "bfloat16", "zamba2")]}))
    # the decode kernel's lse output against its plain version's
    kernels[-1]["lse_max_share"] = attn_errs[("decode_lse", torch.float32)]
    cache_paths = {"cache_segments": segments["launches"],
                   "mesh_step": mesh_step["launches"]["cache_attention"]}
    f32, bf16 = cache_rows[("float32",)], cache_rows[("bfloat16",)]
    kernels.append(dict(
        name="cache_attention", route="cuda",
        source="src/repro_torch/kernels/cache_attention/csrc/"
               "cache_attention.cu",
        # no TPU kernel: the JAX package's plain-jnp read over a cache
        replaces="src/repro/models/layers.py:284",
        launches=sum(cache_paths.values()), launches_by_path=cache_paths,
        max_abs_err=max(f32["max_abs_err"], bf16["max_abs_err"]),
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"],
        lse_max_share=attn_errs[("cache_lse", torch.float32)],
        shapes={"float32": f32, "bfloat16": bf16,
                **{f"{shape}_{dt}": cache_rows[(dt, shape)]
                   for shape in ("zamba2", "mixtral")
                   for dt in ("float32", "bfloat16")}}))
    print(json.dumps({"serve_ms": serve}))
    print(json.dumps({"eval_path": eval_path}))
    print(json.dumps({"cohort_path": cohort}))
    print(json.dumps({"serve_tier": serve_tier}))
    print(json.dumps({"sharded_path": sharded}))
    print(json.dumps({"personalize": pers}))
    print(json.dumps({"train": train}))
    print(json.dumps({"remat": remat}))
    print(json.dumps({"families": families["runs"]}))
    print(json.dumps({"cache_segments": segments}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"dryrun_costs": dry_costs}))
    print(json.dumps({"mesh_step": mesh_step}))
    print(json.dumps({"mesh_families": mesh_families}))
    print(json.dumps({"mesh_recurrent": mesh_recurrent}))
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all",
          flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--dryrun-costs"]:
        sys.exit(dryrun_costs_run(sys.argv[2]))
    sys.exit(main())
