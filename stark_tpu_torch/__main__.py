"""Command-line entry point: ``python -m stark_tpu_torch <command>``.

Counterpart of stark_tpu/__main__.py.  ``demo`` reproduces the reference
binary's behavior (reference src/main.rs:8-14: construct the field, an 8th
primitive root, an empty polynomial, print them); ``prove`` / ``verify`` /
``inspect`` expose the full pipeline; ``bench`` prints the benchmark's JSON
line (``stark_tpu_torch/bench.py``, the counterpart of the repo-root
``bench.py``).  ``prove`` and ``bench`` run on ``--device`` (default
``cuda``): without a card they exit with code 2 and say so, unless
``--device cpu`` asks for the kernels' plain versions.  ``verify`` and
``inspect`` are host work.  Exit codes: 0 done or ACCEPT, 1 REJECT (or a
proof ``bench`` made was rejected), 2 a usage error (a blowup below the
model's minimum, no card).
"""

from __future__ import annotations

import argparse
import sys
import time


def _demo(_args) -> int:
    from stark_tpu_torch import FiniteField, Polynomial

    field = FiniteField()
    omega = field.prim_nth_root(8)
    poly = Polynomial([], field)
    print(f"field: F_p, p = {field.modulus()}")
    print(f"8th primitive root of unity: {omega.value}")
    print(f"empty polynomial: {poly!r}")
    return 0


def _prove(args) -> int:
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import cuda

    air, trace_fn, min_blowup = get_model(args.model)
    if args.blowup < min_blowup:
        print(
            f"model '{args.model}' needs --blowup >= {min_blowup} "
            "(composition degree bookkeeping, see stark._Domain)",
            file=sys.stderr,
        )
        return 2
    try:
        device = cuda.device_or_raise(args.device, "prove")
    except RuntimeError:
        print(f"prove: no CUDA device visible for --device {args.device} "
              "(pass --device cpu for the kernels' plain versions)", file=sys.stderr)
        return 2
    cfg = StarkConfig(
        trace_length=args.trace_length,
        blowup=args.blowup,
        num_colinearity_tests=args.queries,
    )
    # Serving path: fib/mds witnesses are made on the device (K12; bytes
    # identical to the host rows); --host-witness forces the host generator.
    kw = {}
    if not args.host_witness and args.model == "fib":
        from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device

        kw["trace_cols"] = fibonacci_trace_cols_device(args.trace_length, device=device)
    elif not args.host_witness and args.model == "mds":
        from stark_tpu_torch.models.examples import mds_square_trace_cols_device

        kw["trace_cols"] = mds_square_trace_cols_device(args.trace_length, device=device)
    else:
        kw["trace_rows"] = trace_fn(args.trace_length)
    prover = StarkProver(air, cfg, device=device)
    t0 = time.time()
    proof = prover.prove(**kw)
    dt = time.time() - t0
    with open(args.out, "wb") as f:
        f.write(proof)
    print(
        f"proved {args.trace_length}-row {args.model} trace on {device} in {dt:.2f}s "
        f"-> {args.out} ({len(proof)} bytes)"
    )
    return 0


def _verify(args) -> int:
    from stark_tpu_torch import StarkConfig, StarkVerifier
    from stark_tpu_torch.models import get_model

    air, _trace_fn, _min_blowup = get_model(args.model)
    cfg = StarkConfig(
        trace_length=args.trace_length,
        blowup=args.blowup,
        num_colinearity_tests=args.queries,
    )
    proof = open(args.proof, "rb").read()
    t0 = time.time()
    ok = StarkVerifier(air, cfg).verify(proof)
    dt = time.time() - t0
    print(f"verify: {'ACCEPT' if ok else 'REJECT'} in {dt:.3f}s")
    return 0 if ok else 1


def _inspect(args) -> int:
    """Parse a proof file and summarize its objects (wire format:
    reference src/stream.rs:35-64)."""
    from collections import Counter

    from stark_tpu_torch import FiniteField, ProofStream
    from stark_tpu_torch.stream import (
        FieldElementObj,
        FieldElements,
        MerklePath,
        MerkleRoot,
    )

    data = open(args.proof, "rb").read()
    stream = ProofStream.deserialize(data, FiniteField())
    counts = Counter(type(o).__name__ for o in stream.objects)
    print(f"{args.proof}: {len(data)} bytes, {len(stream)} objects")
    for name, c in counts.items():
        print(f"  {name:<16} x{c}")
    for i, obj in enumerate(stream.objects):
        if isinstance(obj, MerkleRoot):
            print(f"  [{i}] MerkleRoot {obj.hash.to_hex()[:16]}…")
        elif isinstance(obj, FieldElements):
            vals = [fe.value for fe in obj.elements[:4]]
            more = "…" if len(obj.elements) > 4 else ""
            print(f"  [{i}] FieldElements({len(obj.elements)}) {vals}{more}")
        elif isinstance(obj, MerklePath):
            print(f"  [{i}] MerklePath({len(obj.path)})")
        elif isinstance(obj, FieldElementObj):
            print(f"  [{i}] FieldElement {obj.element.value}")
        if i >= args.limit:
            print(f"  … ({len(stream) - i - 1} more)")
            break
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stark_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("demo", help="reference main.rs parity demo")

    from stark_tpu_torch.models import MODEL_NAMES

    pp = sub.add_parser("prove", help="prove an example-model trace")
    pp.add_argument("--model", choices=MODEL_NAMES, default="fib")
    pp.add_argument("--trace-length", type=int, default=1024)
    pp.add_argument("--blowup", type=int, default=4)
    pp.add_argument("--queries", type=int, default=16)
    pp.add_argument("--out", default="proof.bin")
    pp.add_argument(
        "--host-witness",
        action="store_true",
        help="force the host trace generator (default: fib/mds witnesses "
        "are made on the device; bytes identical)",
    )
    pp.add_argument(
        "--device",
        default="cuda",
        help="where to prove (default cuda: exits 2 without a card; cpu runs "
        "the kernels' plain torch versions)",
    )

    pv = sub.add_parser("verify", help="verify a proof file")
    pv.add_argument("proof")
    pv.add_argument("--model", choices=MODEL_NAMES, default="fib")
    pv.add_argument("--trace-length", type=int, default=1024)
    pv.add_argument("--blowup", type=int, default=4)
    pv.add_argument("--queries", type=int, default=16)

    pi = sub.add_parser("inspect", help="summarize a proof file's objects")
    pi.add_argument("proof")
    pi.add_argument("--limit", type=int, default=12)

    from stark_tpu_torch import bench

    pb = sub.add_parser("bench", help="the benchmark: one JSON line (bench.py's schema)")
    bench.add_arguments(pb)

    args = p.parse_args(argv)
    return {
        "demo": _demo,
        "prove": _prove,
        "verify": _verify,
        "inspect": _inspect,
        "bench": bench.run,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
