"""Same-process A/B timing of kernel design choices on the card.

Each experiment names variants of the kernel sources in ``csrc/``, each a
set of text edits (a choice switched off or changed), and the shapes at
which K1 (``radic_batched_partial``) or K3 (``radic_batched_grad_partial``)
is timed.  The checkout's sources (``cur``) and every variant are compiled
in parallel into ``build/kernel_ab/``, loaded side by side, and timed on
the same inputs in alternating order (cur, variants, reversed, ...), each
time a CUDA-event window over back-to-back calls: the calls run for
milliseconds, so the window holds device time.  Every variant's result
must equal ``cur``'s bit for bit (no choice here moves arithmetic), and
ptxas's registers and spills are printed for the kernels timed.

    python -m repro_torch.kernels.kernel_ab [EXPERIMENT ...]

(``PYTHONPATH=src``, from the root of a checkout, on a machine with a
card and ``nvcc``).  The last line of its output is one JSON object with
every time.  Without a card it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.pascal import binom_table, comb
from repro_torch.kernels import _build
from repro_torch.kernels import radic_fused as rf

OUT = _build.BUILD_DIR.parent / "kernel_ab"
FUSED = "radic_fused.cu"

# name -> (variants {name: [(file, old, new), ...]}, shapes [(kernel, B, m, n)])
EXPERIMENTS = {
    # K1's batch slice of A and Pascal table staged in shared memory
    # (cp.async) against the gather through L1 that wide n takes
    "k1_stage": ({
        "global": [(FUSED, "if (!staged(M, n)) {", "if (true) {")],
    }, [("K1", 3, 8, 31), ("K1", 1, 10, 34), ("K1", 3, 6, 30)]),
    # K1's register cap: two blocks per SM at m = 9..11, at no m, and at
    # every m >= 9
    "k1_min_blocks": ({
        "one": [(FUSED, "return (M >= 9 && M <= 11) ? 2 : 1;", "return 1;")],
        "two_from_9": [(FUSED, "return (M >= 9 && M <= 11) ? 2 : 1;",
                        "return M >= 9 ? 2 : 1;")],
    }, [("K1", 1, 9, 34), ("K1", 1, 10, 34), ("K1", 1, 11, 30),
        ("K1", 3, 9, 30), ("K1", 3, 10, 28), ("K1", 3, 11, 26),
        ("K1", 1, 12, 30), ("K1", 1, 16, 26)]),
}


def _includes(src: Path) -> set[str]:
    return set(re.findall(r'#include "([^"]+)"', src.read_text()))


def _build_all(variants: dict[str, list]) -> tuple[dict, dict]:
    """Compile ``cur`` and each variant (only the sources its edits reach;
    the rest reuse ``cur``'s objects), link and bind each library; returns
    the libraries and ptxas's registers and spills of each, by name."""
    nvcc = _build._nvcc()
    shutil.rmtree(OUT, ignore_errors=True)
    srcs = sorted(_build.CSRC.glob("*.cu"))
    jobs = {}
    for name, edits in {"cur": [], **variants}.items():
        d = OUT / name
        shutil.copytree(_build.CSRC, d)
        touched = set()
        for fn, old, new in edits:
            text = (d / fn).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in {fn} once; "
                                 "the experiment no longer fits the sources")
            (d / fn).write_text(text.replace(old, new))
            touched.add(fn)
        for s in srcs:
            if name == "cur" or s.name in touched or \
                    _includes(s) & touched or \
                    any(_includes(_build.CSRC / h) & touched
                        for h in _includes(s) if (_build.CSRC / h).exists()):
                cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                       str(d / f"{s.name}.o"), str(d / s.name)]
                jobs[(name, s.name)] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
    logs = {}
    for (name, src), proc in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}/{src}:\n{text[-4000:]}")
        logs[name] = logs.get(name, "") + text
    libs, ptxas = {}, {}
    for name in {"cur": [], **variants}:
        d = OUT / name
        objs = [str((d if (d / f"{s.name}.o").exists() else OUT / "cur")
                    / f"{s.name}.o") for s in srcs]
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(d / "lib.so"), *objs],
                       check=True)
        libs[name] = _build._bind(ctypes.CDLL(str(d / "lib.so")))
        ptxas[name] = _ptxas(logs.get(name, "") or logs["cur"])
    return libs, ptxas


def _ptxas(log: str) -> dict[str, str]:
    """K1<m> / K3<m> -> 'registers r, spill s B' from ptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        e = re.search(r"entry function '(\w+)'", line)
        if e:
            k1 = re.search(r"radic_partial_kernelILi(\d+)ELb(\d)", e.group(1))
            k3 = re.search(r"radic_grad_partial_kernelILi(\d+)E", e.group(1))
            cur = (f"K1<{k1.group(1)},{'staged' if k1.group(2) == '1' else 'global'}>"
                   if k1 else f"K3<{k3.group(1)}>" if k3 else None)
        sp = re.search(r"(\d+) bytes spill stores", line)
        if cur and sp:
            out[cur] = f"spill {sp.group(1)} B"
        r = re.search(r"Used (\d+) registers", line)
        if cur and r:
            out[cur] = f"{r.group(1)} regs, {out.get(cur, 'spill 0 B')}"
            cur = None
    return out


def _call(lib, kernel: str, As, cts, table, count: int):
    """A closure launching one call of `kernel`, and its output."""
    B, m, n = As.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if kernel == "K1":
        G = rf.grid_blocks(count)
        part = torch.empty((G, B), device="cuda")
        out = torch.empty((B,), device="cuda")
        args = (As.data_ptr(), B, m, n, table.data_ptr(), 0, count,
                part.data_ptr(), G, out.data_ptr(), stream)
        fn = lib.radic_batched_partial
    else:
        G = rf.grad_grid_blocks(count, m, n, lib.radic_grad_tile(m))
        part = torch.empty((G, B, m, n), device="cuda")
        out = torch.empty((B, m, n), device="cuda")
        args = (As.data_ptr(), cts.data_ptr(), B, m, n, table.data_ptr(), 0,
                count, part.data_ptr(), G, out.data_ptr(), stream)
        fn = lib.radic_batched_grad_partial

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(lib.radic_error_string(rc).decode())
    return run, out


def _window_ms(run, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(EXPERIMENTS)
    unknown = set(names) - set(EXPERIMENTS)
    if unknown:
        print(f"unknown experiments {sorted(unknown)}; "
              f"known: {list(EXPERIMENTS)}", file=sys.stderr)
        return 2
    variants = {}
    for e in names:
        for v, edits in EXPERIMENTS[e][0].items():
            variants[f"{e}.{v}"] = edits
    libs, ptxas = _build_all(variants)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result, ok = {"card": card.strip(), "rounds": 4, "times": []}, True
    for e in names:
        for kernel, B, m, n in EXPERIMENTS[e][1]:
            order = ["cur", *(f"{e}.{v}" for v in EXPERIMENTS[e][0])]
            As = torch.randn(B, m, n, device="cuda", generator=gen)
            cts = torch.randn(B, device="cuda", generator=gen)
            table = torch.as_tensor(binom_table(n, m, dtype=np.int32)).cuda()
            count = comb(n, m)
            calls = {v: _call(libs[v], kernel, As, cts, table, count)
                     for v in order}
            for v in list(order):
                try:
                    calls[v][0]()
                    torch.cuda.synchronize()
                except RuntimeError as err:
                    print(f"{e} {kernel} ({B}, {m}, {n}) {v}: FAILED {err}",
                          flush=True)
                    order.remove(v)
                    ok = False
            reps = max(3, math.ceil(150.0 / _window_ms(calls["cur"][0], 1)))
            ms = {v: [] for v in order}
            for rnd in range(result["rounds"]):
                for v in (order if rnd % 2 == 0 else order[::-1]):
                    ms[v].append(_window_ms(calls[v][0], reps))
            want = calls["cur"][1]
            for v in order:
                got = calls[v][1]
                same = bool(torch.equal(got, want))
                ok &= same
                key = f"K{kernel[1]}<{m}"
                regs = "; ".join(f"{k} {s}" for k, s in
                                 ptxas[v].items() if k.startswith(key))
                print(f"{e} {kernel} ({B}, {m}, {n}) {v}: mean "
                      f"{sum(ms[v]) / len(ms[v]):.4f} ms, rounds "
                      f"{' '.join(f'{t:.4f}' for t in ms[v])}, "
                      f"{'same bits' if same else 'BITS DIFFER'}; {regs}",
                      flush=True)
                result["times"].append(dict(
                    experiment=e, kernel=kernel, shape=[B, m, n], variant=v,
                    ms=ms[v], reps=reps, same_bits=same, ptxas=regs))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
