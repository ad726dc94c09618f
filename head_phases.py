#!/usr/bin/env python3
"""Where a block of the plastic head's staged kernel spends its time, on one CUDA card.

    python3 head_phases.py        # from the repository root

Builds a copy of ``plastic_unet_tpu_torch/csrc/plastic_head.cu`` with
clock64 stamps into ``build/plastic_unet_tpu_torch/head_phases/``: after a
barrier, thread 0 of block (0, 0, 0) records the SM clock at each phase
boundary of ``plastic_head_staged`` (start, copies issued, copies landed,
activin transposed, eff built, products done, activ staged, outputs
written). The barriers change no value: each launch is held bit for bit
against the uninstrumented kernel. Prints, at n=101, for the "spread"
family at B=1 and the "sample" family at B=1 and B=128 (oja, free alpha):
the device time of one launch (chip_smoke.time_ms) and the cycles of each
phase of block 0; and the time of an empty kernel and of a one-element
``add_`` under the same clock, the floor of any launch's time. Cycles are
SM clocks of one block; the sum is not the kernel's time, which adds the
launch and the other blocks. Then the time of each tile family, forced,
at the batch sizes of SWEEP, beside the one head_plan picks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "plastic_unet_tpu_torch", "head_phases")
PHASES = ["issue copies", "copies land", "transpose", "eff", "products", "stage activ", "outputs"]
SWEEP = (1, 2, 4, 8, 9, 12, 16, 24, 32, 33, 37, 48, 64, 96, 128)


def instrumented_source() -> str:
    src = open(os.path.join(REPO, "plastic_unet_tpu_torch", "csrc", "plastic_head.cu")).read()
    pre = ("__device__ long long g_stamps[8];\n"
           "#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 "
           "&& blockIdx.z == 0) g_stamps[i] = clock64(); } while (0)\n"
           "__global__ void empty_kernel(float* p) { if (p != nullptr) p[0] = 1.0f; }\n")

    def put(text, add, before=False, count=1):
        nonlocal src
        if src.count(text) != count:
            raise RuntimeError(f"head_phases: the kernel source changed; no single place for {text!r}")
        src = src.replace(text, (add + text) if before else (text + add))

    put("namespace {\n", pre)
    put("  const float a_scalar = SCALAR_ALPHA ? a.alpha[0] : 0.0f;\n  float *xs", "  STAMP(0);\n", before=True)
    put("    cp_async_wait_all();\n", "    STAMP(1);\n", before=True, count=2)
    put("    cp_async_wait_all();\n    __syncthreads();\n", "    STAMP(2);\n", count=2)
    put("    for (int r = tid; r < n; r += blockDim.x) x0s[r] = eb[mx + r];\n    __syncthreads();\n", "    STAMP(3);\n")
    put("    for (int i = tid, k = tid / nc, lc = tid - tid / nc * nc; i < n * nc; i += blockDim.x) {\n"
        "      const int e", "    STAMP(3);\n", before=True)
    put("\n  // The products", "  STAMP(4);\n", before=True)
    put("  __syncthreads();  // xs is read no more", "  STAMP(5);\n", before=True)
    put("  const float et = a.eta[0];\n  const int per", "  STAMP(6);\n", before=True)
    put("}\n\n// The thread tiles", "  STAMP(7);\n", before=True)
    src += ('\nextern "C" int read_stamps(long long* out) { return (int)cudaMemcpyFromSymbol(out, g_stamps, '
            'sizeof(g_stamps)); }\n'
            'extern "C" int empty_launch(void* s) { empty_kernel<<<1, 32, 0, (cudaStream_t)s>>>(nullptr); '
            'return (int)cudaGetLastError(); }\n')
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("head_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import time_ms
    from plastic_unet_tpu_torch.ops import _build
    from plastic_unet_tpu_torch.ops import plastic_head as hm

    os.makedirs(OUT, exist_ok=True)
    cu, lib_path = os.path.join(OUT, "plastic_head_phases.cu"), os.path.join(OUT, "libplastic_head_phases.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.plastic_head_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    one = torch.zeros(1, device=dev)
    print(f"empty kernel: {time_ms(lambda: lib.empty_launch(stream))[0]:.4f} ms; one-element add_: "
          f"{time_ms(lambda: one.add_(1.0))[0]:.4f} ms", flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    n = 101
    w, alpha = 0.01 * torch.randn(n, n, generator=g, device=dev), 0.01 * torch.rand(n, n, generator=g, device=dev)
    eta = torch.full((1,), 0.01, device=dev)
    for b, family in ((1, "spread"), (1, "sample"), (128, "sample")):
        p = hm.head_plan(b, n, family=family)
        x, hebb = torch.randn(b, n, n, generator=g, device=dev), 0.1 * torch.randn(b, n, n, generator=g, device=dev)
        outs = [torch.empty_like(x) for _ in range(3)]

        def launch():
            return lib.plastic_head_forward(*(_build.ptr(t) for t in (x, w, alpha, eta, hebb, *outs)), b, n, 1, 0,
                                            hm.FAMILIES.index(family), p.br, p.bc, p.xs, p.es, p.threads, p.smem,
                                            stream)

        _build.check(launch(), "head_phases")
        ref = hm.plastic_head(w, alpha, eta, x, hebb, rule="oja", plan=p)
        if not all(bool(torch.equal(a, r)) for a, r in zip(outs, ref)):
            raise RuntimeError(f"head_phases: the instrumented {family} kernel changed some bit")
        ms = time_ms(launch)[0]
        stamps = (ctypes.c_longlong * 8)()
        torch.cuda.synchronize()
        _build.check(lib.read_stamps(stamps), "head_phases: reading the stamps")
        cyc = {name: stamps[i + 1] - stamps[i] for i, name in enumerate(PHASES)}
        if family == "spread":  # no transpose: its stamp marks the same point as the copies' landing
            cyc["eff"] += cyc.pop("transpose")
        print(f"plastic_head {family} B={b} n={n} oja: {ms:.4f} ms; block 0, SM cycles: {cyc}; "
              f"sum {stamps[7] - stamps[0]}", flush=True)
    for b in SWEEP:  # the batch ranges of head_plan's families
        x, hebb = torch.randn(b, n, n, generator=g, device=dev), 0.1 * torch.randn(b, n, n, generator=g, device=dev)
        ms = {}
        for family in hm.FAMILIES:
            p = hm.head_plan(b, n, family=family)
            ms[family] = round(time_ms(lambda: hm.plastic_head(w, alpha, eta, x, hebb, rule="oja", plan=p))[0], 4)
        print(f"plastic_head B={b} n={n} oja, ms by family: {ms}; the plan takes {hm.head_plan(b, n).family}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
