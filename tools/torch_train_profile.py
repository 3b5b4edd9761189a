#!/usr/bin/env python3
"""Where a training step of the PyTorch port's FCNN trainer spends its time.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 tools/torch_train_profile.py [--batch-size 64] [--warmup 50] [--steps 200]
        [--schedule gpipe|1f1b|interleaved | --conv | --hetero | --lm | --generate]

Builds ``chip_smoke.py``'s full-width training recipe (784-128-64-10,
relu / relu / softmax, Adam at 1e-3, seeded weights, ``synthetic_mnist``
rows) and profiles two arms of the same step in turns (eager, graphed):
the eager step (``tpu_dist_nn_torch.train.trainer.make_train_step``,
the batch copied to the card each step) and the captured one the trainer
runs on a card (``compile_train_step``: static batch buffers fed through
pinned memory, one CUDA graph replay a step). Each arm runs ``--warmup``
steps, then ``--steps`` more timed on the host clock (ending in a
synchronise), then ``--steps`` more under ``torch.profiler`` (CPU and
CUDA activities). Prints, for each arm, the step's wall time with the
profiler off and on, the device time per step by group (matrix
products, copies, everything else), the device operations per step, and
the share of the profiled wall time in which the device ran nothing
(the union of the device operations' intervals against the wall).
``--schedule`` profiles the pipelined step instead
(``tpu_dist_nn_torch.train.pipeline_trainer.make_pipeline_train_step``
and ``compile_pipeline_step`` on ``[1, 1, 1]`` over three stage slots of
the card, or ``[1, 1, 1, 0]`` at 2 virtual stages over two for
``interleaved``, 4 microbatches) and also prints the host operations
with the most self time. ``--lm`` profiles the 85M LM step of
``chip_smoke.py``'s LM path instead (d 768, 12 heads, 12 layers, T 1024,
batch 16 of the vendored corpus, bf16 over float32 masters, remat, Adam
at 3e-4, seeded weights; ``make_lm_train_step`` eager, and captured as
``train_lm`` captures it on a card), 5 warm-up and 10 timed steps unless
given. ``--generate`` profiles one decode step of that LM's generation
(``tpu_dist_nn_torch.models.generate``: seeded weights in bf16, batch
16, a 128-byte prompt, a 639-position cache as for 512 new tokens; the
eager step, and its captured graph as ``generate`` replays it), 10
warm-up and 200 timed steps unless given. ``--conv`` profiles the conv
step of ``chip_smoke.py``'s conv train path instead (BASELINE
``configs[3]``: ``init_conv_mlp``'s defaults, seeded, 32x32x3 rows of
``synthetic_mnist``; ``make_network_train_step`` eager and captured by
``compile_train_step``), and ``--hetero`` that network's step through
the heterogeneous pipeline on ``[2, 2, 2]`` over three stage slots of
the card, 4 microbatches (``make_hetero_train_step``). Exits 1 when the
profiler recorded no device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def group_of(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul", "gemv")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, loss, optimizer)"


def busy_ms(prof, device_type) -> float:
    """Milliseconds in which the device ran at least one operation: the
    union of the profiled device operations' intervals (operations on
    several streams overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == device_type and e.time_range.end > e.time_range.start)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--schedule", choices=["gpipe", "1f1b", "interleaved"], default=None,
                    help="profile the pipelined step on [1, 1, 1] (three slots of the card; "
                         "interleaved: [1, 1, 1, 0] at 2 virtual stages on two)")
    ap.add_argument("--conv", action="store_true",
                    help="profile the configs[3] conv step, one program")
    ap.add_argument("--hetero", action="store_true",
                    help="profile the configs[3] conv step through [2, 2, 2]")
    ap.add_argument("--lm", action="store_true", help="profile the 85M LM step")
    ap.add_argument("--generate", action="store_true",
                    help="profile the 85M LM's decode step")
    args = ap.parse_args(argv)
    if args.generate:
        args.batch_size = 16
        if "--warmup" not in (argv or sys.argv):
            args.warmup = 10
        if "--steps" not in (argv or sys.argv):
            args.steps = 200
    elif args.lm:
        args.batch_size = 16
        if "--warmup" not in (argv or sys.argv):
            args.warmup = 5
        if "--steps" not in (argv or sys.argv):
            args.steps = 10
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.data.datasets import synthetic_mnist
    from tpu_dist_nn_torch.data.feed import batch_iterator
    from tpu_dist_nn_torch.models.fcnn import init_fcnn
    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        _split_params,
        compile_train_step,
        make_train_step,
        optimizer_for,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    acts = ["relu", "relu", "softmax"]
    conv = args.conv or args.hetero
    data = synthetic_mnist(args.batch_size * (args.warmup + 2 * args.steps),
                           dim=3072 if conv else 784, seed=0)
    what = "one program"
    if args.schedule:
        v = 2 if args.schedule == "interleaved" else 1
        dist = [1, 1, 1, 0] if v == 2 else [1, 1, 1]
        what = (f"the {args.schedule} pipeline on {dist}, {len(dist) // v} slots, "
                "4 microbatches")

    if conv:
        what = ("the configs[3] conv network (32x32x3, conv 16 + pool, conv 32 + pool, "
                "2048-64-10), " + ("[2, 2, 2] on three slots, 4 microbatches" if args.hetero
                                   else "one program"))
    if args.lm:
        what = "the 85M LM (d 768, 12 layers, T 1024, bf16, remat)"
    if args.generate:
        what = "the 85M LM's decode step (bf16, prompt 128, cache 639)"

    def build_generate(graphed: bool):
        from tpu_dist_nn_torch.data.text import encode, lm_sequences, load_corpus
        from tpu_dist_nn_torch.models.generate import _compiled_generate
        from tpu_dist_nn_torch.models.transformer import TransformerConfig, init_transformer

        cfg = TransformerConfig(vocab_size=256, d_model=768, n_heads=12, n_layers=12,
                                d_ff=3072, max_seq_len=1024, compute_dtype="bfloat16")
        params = init_transformer(torch.Generator().manual_seed(0), cfg, device=dev)
        prompt = torch.as_tensor(lm_sequences(encode(load_corpus()[0]), 1024)[-16:, :128],
                                 device=dev).long()
        new = 512
        if args.warmup + 2 * args.steps > new - 1:
            raise SystemExit(f"--warmup + 2 --steps must stay within {new - 1} decode steps")
        prog = _compiled_generate(cfg, 16, 128, new, 0.0, None, None, None, prompt.device)
        prog.start(params, prompt, None)

        def one_step(_bx, _by):
            prog.decode(1, graphed=graphed)
        return one_step

    def build_lm(graphed: bool):
        from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences, load_corpus
        from tpu_dist_nn_torch.models.transformer import (
            TransformerConfig,
            init_transformer,
            param_leaves,
            tree_map,
        )
        from tpu_dist_nn_torch.train.graphs import CompiledStep
        from tpu_dist_nn_torch.train.lm_trainer import make_lm_train_step
        from tpu_dist_nn_torch.train.optimizers import build_optimizer

        cfg = TransformerConfig(vocab_size=256, d_model=768, n_heads=12, n_layers=12,
                                d_ff=3072, max_seq_len=1024, compute_dtype="bfloat16",
                                remat=True)
        stream = lm_batches(lm_sequences(encode(load_corpus()[0]), 1024), 16, seed=0,
                            epochs=None)
        params = tree_map(lambda a: a.requires_grad_(True),
                          init_transformer(torch.Generator().manual_seed(0), cfg, device=dev))
        opt = build_optimizer(3e-4)
        state = opt.init(param_leaves(params))
        step = make_lm_train_step(cfg, opt)
        if graphed:
            compiled = CompiledStep(step, (params, state), [((16, 1025), torch.int64)], opt,
                                    state, dev)

            def one_step(_bx, _by):
                compiled(next(stream))
        else:
            def one_step(_bx, _by):
                step(params, state, torch.from_numpy(next(stream)).to(dev).long())
        return one_step

    def build_conv(graphed: bool):
        from tpu_dist_nn_torch.models.network import build_network, init_conv_mlp
        from tpu_dist_nn_torch.parallel.hetero_pipeline import HeteroPipeline
        from tpu_dist_nn_torch.train.hetero_trainer import make_hetero_train_step
        from tpu_dist_nn_torch.train.trainer import _trainable, make_network_train_step

        spec = init_conv_mlp(torch.Generator().manual_seed(0))
        opt = optimizer_for(TrainConfig(batch_size=args.batch_size), data)
        if args.hetero:
            hp = HeteroPipeline(spec, [2, 2, 2], devices=[dev] * 3)
            p = _trainable(hp.stage_params())
            step = make_hetero_train_step(hp, opt, 4)
        else:
            plan, params = build_network(spec, device=dev)
            p = _trainable(params)
            step = make_network_train_step(plan, opt)
        state = opt.init(_leaves(p))
        if graphed:
            return compile_train_step(step, p, state, opt, args.batch_size, spec.input_dim)

        def one_step(bx, by):
            step(p, state, torch.as_tensor(bx, device=dev),
                 torch.as_tensor(by, dtype=torch.long, device=dev))
        return one_step

    def build(graphed: bool):
        """A fresh step from the seeded weights: ``one_step(bx, by)``."""
        if args.generate:
            return build_generate(graphed)
        if args.lm:
            return build_lm(graphed)
        if conv:
            return build_conv(graphed)
        params = init_fcnn(torch.Generator().manual_seed(0), [784, 128, 64, 10], acts,
                           device=dev)
        opt = optimizer_for(TrainConfig(batch_size=args.batch_size), data)
        if args.schedule:
            from tpu_dist_nn_torch.core.schema import partition_model
            from tpu_dist_nn_torch.models.fcnn import spec_from_params
            from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
            from tpu_dist_nn_torch.parallel.pipeline import build_pipeline_params
            from tpu_dist_nn_torch.train.pipeline_trainer import (
                _leaves as stage_leaves,
                compile_pipeline_step,
                make_pipeline_train_step,
                place_leaves,
                prepare_pipeline_batch,
            )

            spec = spec_from_params(params, acts)
            pp = build_pipeline_params(partition_model(spec, dist))
            mesh = build_mesh(MeshSpec(stage=len(dist) // v), [dev] * (len(dist) // v))
            placed = place_leaves(mesh, pp, v)
            pstate = opt.init(stage_leaves(placed))
            pstep = make_pipeline_train_step(mesh, pp.meta, 4, opt, schedule=args.schedule,
                                             num_virtual=v)
            if graphed:
                compiled = compile_pipeline_step(pstep, placed, pstate, opt, 4, args.batch_size)

                def one_step(bx, by):
                    xs, labels, mask = prepare_pipeline_batch(pp.meta, bx, by, 4, 1)
                    compiled(xs[:, :, :784], labels, mask)
            else:
                def one_step(bx, by):
                    pstep(placed, pstate, *prepare_pipeline_batch(pp.meta, bx, by, 4, 1))
            return one_step
        wb, ids = _split_params(params)
        state = opt.init(_leaves(wb))
        step = make_train_step(ids, opt)
        if graphed:
            return compile_train_step(step, wb, state, opt, args.batch_size, 784)

        def one_step(bx, by):
            x = torch.as_tensor(bx, dtype=torch.float32, device=dev)
            y = torch.as_tensor(by, dtype=torch.long, device=dev)
            step(wb, state, x, y)

        return one_step

    def profile_arm(label: str, graphed: bool) -> bool:
        one_step = build(graphed)
        rows = 64 if args.lm or args.generate else args.batch_size
        batches = batch_iterator(data.x, data.y, rows, shuffle=True, seed=0,
                                 drop_remainder=True)

        def run(n):
            for _ in range(n):
                one_step(*next(batches))
            torch.cuda.synchronize()

        run(args.warmup)
        t0 = time.perf_counter()
        run(args.steps)
        plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(args.steps)
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        per_step = {e.key: e.self_device_time_total / 1e3 / args.steps for e in events}
        counts = {e.key: e.count / args.steps for e in events}
        total = sum(per_step.values())
        if total <= 0:
            print(f"torch_train_profile: the profiler recorded no device time ({label})",
                  file=sys.stderr)
            return False
        busy = busy_ms(prof, DeviceType.CUDA) / args.steps
        rate = (f"{16 * 1024 / plain_ms * 1e3:.1f} tokens/s" if args.lm
                else f"{16 / plain_ms * 1e3:.1f} tokens/s" if args.generate
                else f"{args.batch_size / plain_ms * 1e3:.1f} samples/s")
        print(f"{label}: wall {plain_ms:.4f} ms/step (host clock, profiler off; "
              f"{rate}), {wall_ms:.4f} ms/step "
              f"profiler on; device time {total:.4f} ms/step, device busy {busy:.4f} ms/step; "
              f"device idle {100 * (1 - busy / wall_ms):.1f}% of the profiled wall time; "
              f"{sum(counts.values()):.1f} device operations/step")
        groups: dict[str, list[float]] = {}
        for key, ms in per_step.items():
            g = groups.setdefault(group_of(key), [0.0, 0.0])
            g[0] += ms
            g[1] += counts[key]
        for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:9.4f} ms/step  {100 * ms / total:5.1f}% of device time  "
                  f"{n:6.1f} operations/step  {group}")
        print(f"  top device operations (ms/step, count/step):")
        for key, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.4f}  {counts[key]:6.1f}  {key[:110]}")
        if args.schedule or args.hetero or graphed:
            host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
            print("  top host operations by self time (ms/step, count/step; profiler on):")
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
                print(f"  {e.self_cpu_time_total / 1e3 / args.steps:9.4f}  "
                      f"{e.count / args.steps:6.1f}  {e.key[:110]}")
        return True

    model = "" if args.lm or args.generate or conv else "784-128-64-10 "
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{model}at batch {args.batch_size}, {what}; {args.steps} steps timed after "
          f"{args.warmup}, {args.steps} more profiled")
    ok = profile_arm("eager", False) and profile_arm("graphed", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
