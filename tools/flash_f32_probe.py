"""What bounds the float32 route of the flash-attention kernel (K5) on
the card.

The route runs q K^T and P V on the tensor cores as three TF32 products
a k-step (``mma.sync.m16n8k8``), splitting every float32 operand into
two TF32 halves in registers.  At (B, S, H/KV, dh) = (1, 4096, 24/8,
128), causal, N(0, 1) inputs, this times, ms a call with CUDA events
after warm-up, in turns (each twice):

* ``built``: the committed kernel (``csrc/flashattn.cu``): hi rounded
  to nearest in two integer operations, lo = x - hi passed whole (the
  tensor core truncates it);
* ``cvt.rna``: the same with both halves rounded by
  ``cvt.rna.tf32.f32`` (the first design);
* ``one product``: the same source with the two correction products
  removed (``a_hi b_hi`` only): what the tensor-core products cost;
* ``no split``: three products on hi = x and lo = 0, no split work:
  what the splits cost on the ALU;
* ``B truncated``: K and V split by truncation (hi = x as it stands,
  which the tensor core truncates, lo = x - x truncated: two operations
  in place of three), Q and P as built;
* ``32-key tiles``: KV tiles of 32 keys in place of 64;
* ``no softmax`` (timing only): P = S, no mask, max, exp or rescale:
  what the softmax between the two products costs;
* ``no end barrier`` (timing only, racy): without the barrier that
  lets the next copies refill a stage: what the warps' waiting costs;
* ``scaled_dot_product_attention`` (KV heads repeated beforehand) and
  the plain version.

Then an ``mma.sync`` TF32 rate microbenchmark (this file's own source):
8 independent m16n8k8 accumulators a warp, 1,056 blocks of 8 warps:
(a) one product a step on fixed operands; (b) a fresh B pair a step,
split into TF32 halves by ``cvt.rna.tf32.f32``, and three products
(the kernel's ratio of ALU work to products); (c) the same with the
split as built; (d) and (e), (a) and (c) at 132 blocks, one block of 8
warps an SM as in the kernel; (f) (e) with the products issued one
product at a time over the 8 accumulators.  TFLOP/s count 2 x 16 x 8 x
8 a product, against the card's 495 TFLOP/s of dense TF32.

And the SASS opcodes of each ``flash_f32_kernel`` instantiation, most
frequent first (``cuobjdump -sass``; ``<128>``'s whole listing goes to
``build/kernels/flash_f32_probe/flash_f32_128.sass``), and their
``ptxas`` lines.  The variants' outputs are held against the plain
version to say how far each is from it: only ``built`` and ``32-key
tiles`` must meet 3e-5.
Needs a CUDA card and nvcc:

    PYTHONPATH=src python tools/flash_f32_probe.py
"""
from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

from chip_smoke import cuobjdump_path, flash_cost  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flashattn import kernel as fk  # noqa: E402
from repro_torch.kernels.flashattn import flash_attention_gqa_ref  # noqa: E402

SHAPE = (1, 4096, 24, 8, 128)
ITERS = 10
TF32_OPS_PER_S = 495e12
CORRECTIONS = "  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n"
SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
CVT_SPLIT = ("  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(\n"
             "      x - __uint_as_float(hi)));\n")
TRUNC_SPLIT = """
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// d (16 x 8, float32)"""
NAMES = ("built", "cvt.rna", "one product", "no split", "B truncated",
         "32-key tiles", "no softmax", "no end barrier")
SOFTMAX = ("      // online softmax", "      // O += P V")
END_BARRIER = ("    __syncthreads();           // before the next pass "
               "refills this stage\n")

MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE>
__global__ void mma_rate(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = tf32_rna(1.0f + 0.001f * (lane + i));
  float d[8][4];
  for (int n = 0; n < 8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.0f;
  float x = lane * 1e-3f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (MODE == 0) {
        mma(d[n], a, a[0], a[1]);
      } else if (MODE == 2) {
        const float y0 = x + n, y1 = x - n;
        const uint32_t h0 = (__float_as_uint(y0) + 0x1000u) & 0xFFFFE000u;
        const uint32_t h1 = (__float_as_uint(y1) + 0x1000u) & 0xFFFFE000u;
        const uint32_t l0 = __float_as_uint(y0 - __uint_as_float(h0));
        const uint32_t l1 = __float_as_uint(y1 - __uint_as_float(h1));
        mma(d[n], a, h0, h1);
        mma(d[n], a, l0, l1);
        mma(d[n], a, h0, h1);
      } else if (MODE == 1) {
        const float y0 = x + n, y1 = x - n;
        const uint32_t h0 = tf32_rna(y0), h1 = tf32_rna(y1);
        const uint32_t l0 = tf32_rna(y0 - __uint_as_float(h0));
        const uint32_t l1 = tf32_rna(y1 - __uint_as_float(h1));
        mma(d[n], a, h0, h1);
        mma(d[n], a, l0, l1);
        mma(d[n], a, h0, h1);
      }
    }
    if (MODE == 3) {
      // as 2, the products of the 8 accumulators issued one product at a
      // time: no two neighbours depend on each other
      uint32_t h[8][2], l[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float y0 = x + n, y1 = x - n;
        h[n][0] = (__float_as_uint(y0) + 0x1000u) & 0xFFFFE000u;
        h[n][1] = (__float_as_uint(y1) + 0x1000u) & 0xFFFFE000u;
        l[n][0] = __float_as_uint(y0 - __uint_as_float(h[n][0]));
        l[n][1] = __float_as_uint(y1 - __uint_as_float(h[n][1]));
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(d[n], a, h[n][0], h[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(d[n], a, l[n][0], l[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) mma(d[n], a, h[n][0], h[n][1]);
    }
    x += 1.0f;
  }
  float s = 0.0f;
  for (int n = 0; n < 8; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate_launch(float* out, int blocks, int threads,
                               int iters, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) mma_rate<0><<<blocks, threads, 0, s>>>(out, iters);
  else if (mode == 1) mma_rate<1><<<blocks, threads, 0, s>>>(out, iters);
  else if (mode == 2) mma_rate<2><<<blocks, threads, 0, s>>>(out, iters);
  else mma_rate<3><<<blocks, threads, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_variants() -> dict:
    """name -> (library, source path) of the kernel's variants."""
    src = fk.SOURCE.read_text()
    assert src.count(CORRECTIONS) == 1 and src.count(SPLIT) == 1
    trunc = src.replace("\n// d (16 x 8, float32)", TRUNC_SPLIT, 1)
    for name in ("kx.x", "kx.y", "kx.z", "kx.w", "x0.x", "x1.x", "x0.y",
                 "x1.y"):
        trunc = trunc.replace(f"split_tf32({name}", f"split_trunc({name}")
    assert trunc.count("split_trunc(") == 9
    lo = src.index(SOFTMAX[0])
    hi = src.index(SOFTMAX[1], lo)
    assert src.count(END_BARRIER) == 1
    variants = {"built": src,
                "cvt.rna": src.replace(SPLIT, CVT_SPLIT),
                "one product": src.replace(CORRECTIONS, ""),
                "no split": src.replace(SPLIT, "  hi = __float_as_uint(x);\n"
                                              "  lo = 0u;\n"),
                "B truncated": trunc,
                "32-key tiles": src.replace("kF32Keys = 64;",
                                            "kF32Keys = 32;"),
                "no softmax": src[:lo] + src[hi:],
                "no end barrier": src.replace(END_BARRIER, "")}
    assert variants["32-key tiles"] != src
    out = _build.BUILD_DIR / "flash_f32_probe"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(variants.items()):
        paths[name] = out / f"variant{i}.cu"
        paths[name].write_text(text)
    mma_path = out / "mma_rate.cu"
    mma_path.write_text(MMA_SOURCE)

    def declare_mma(lib):
        lib.mma_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.mma_rate_launch.restype = ctypes.c_int

    jobs = {name: (f"flash_f32_probe{i}", path, fk._declare, fk.EXTRA_FLAGS)
            for i, (name, path) in enumerate(paths.items())}
    jobs["mma"] = ("flash_f32_mma", mma_path, declare_mma, ())
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(_build.load, *args)
                for name, args in jobs.items()}
        return {name: (f.result(), jobs[name][0]) for name, f in futs.items()}


def launch(lib, q, k, v, causal=True):
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, s, h, k.shape[2], dh, 0, int(causal), 0, 1.0 / dh ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention_launch")
    return out


def cuda_ms(fn, iters=ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def sass_histogram(lib_name: str) -> dict:
    sass = subprocess.run(
        [cuobjdump_path(), "-sass", _build.build_report(lib_name)["path"]],
        capture_output=True, text=True, check=True, timeout=300).stdout
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")
    found, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            found[func] = collections.Counter()
        elif func is not None:
            m = insn.search(line)
            if m:
                found[func][m.group(1)] += 1
    return {f: c for f, c in found.items() if "flash_f32_kernel" in f}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    libs = build_variants()
    report = _build.build_report(libs["built"][1])["ptxas"].splitlines()
    for i, line in enumerate(report):
        if "Compiling entry" in line and "flash_f32_kernel" in line:
            print("ptxas:", line.strip())
            print("ptxas:", " | ".join(x.strip() for x in report[i + 1:i + 4]))
    sass = subprocess.run(
        [cuobjdump_path(), "-sass",
         _build.build_report(libs["built"][1])["path"]],
        capture_output=True, text=True, check=True, timeout=300).stdout
    funcs = sass.split("Function : ")
    listing = "".join(f for f in funcs if f.startswith("_Z")
                      and "flash_f32_kernel" in f.split()[0]
                      and "Li128ELb0E" in f.split()[0])
    (_build.BUILD_DIR / "flash_f32_probe" / "flash_f32_128.sass").write_text(
        listing)
    for name in NAMES:
        for func, hist in sass_histogram(libs[name][1]).items():
            if name == "built" or "Li128ELb0E" in func:
                print(f"SASS {name} {func}: {sum(hist.values())} "
                      f"instructions; {hist.most_common(24)}")

    b, s, h, kv, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = [torch.randn((b, s, n, dh), generator=gen, device="cuda")
               for n in (h, kv, kv)]
    want = flash_attention_gqa_ref(q, k, v, causal=True)
    n_bytes, n_ops = flash_cost(SHAPE, True, 4)
    tf32_ms = 3 * n_ops / TF32_OPS_PER_S * 1e3
    print(f"shape (B, S, H/KV, dh) = ({b}, {s}, {h}/{kv}, {dh}) float32 "
          f"causal: {n_ops:.4g} operations; three TF32 products at "
          f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s {tf32_ms:.3f} ms, the "
          f"float32 pipe at 67 TFLOP/s {n_ops / 67e12 * 1e3:.3f} ms")
    times = collections.defaultdict(list)
    for name in NAMES:
        lib = libs[name][0]
        got = launch(lib, q, k, v)
        torch.cuda.synchronize()
        gap = (got - want).abs()
        excess = float((gap / (3e-5 + 3e-5 * want.abs())).max())
        print(f"  {name}: max |diff| {float(gap.max()):.3g}, largest gap / "
              f"allowed (3e-5) {excess:.3g}")
        if name in ("built", "32-key tiles") and excess > 1:
            raise AssertionError(f"{name} misses 3e-5")
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    runs = {name: (lambda lib=libs[name][0]: launch(lib, q, k, v))
            for name in NAMES}
    runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(cuda_ms(fn))
    times["plain"].append(cuda_ms(
        lambda: flash_attention_gqa_ref(q, k, v, causal=True), 2))
    for name, ts in times.items():
        tflops = n_ops / min(ts) / 1e9
        print(f"  {name}: {', '.join(f'{t:.3f}' for t in ts)} ms "
              f"({tflops:.1f} TFLOP/s of the function)")

    mma_lib = libs["mma"][0]
    threads, iters = 256, 2048
    out = torch.empty(132 * 8 * threads, device="cuda")
    for mode, label, per_step, blocks in (
            (0, "(a) one product a step", 1, 132 * 8),
            (1, "(b) B split by cvt.rna + three products", 3, 132 * 8),
            (2, "(c) B split as built + three products", 3, 132 * 8),
            (0, "(d) = (a) at one block of 8 warps an SM", 1, 132),
            (2, "(e) = (c) at one block of 8 warps an SM", 3, 132),
            (3, "(f) = (e), one product at a time over the 8 "
                "accumulators", 3, 132)):
        def run(mode=mode, blocks=blocks):
            _build.check(mma_lib.mma_rate_launch(
                out.data_ptr(), blocks, threads, iters, mode,
                torch.cuda.current_stream().cuda_stream), "mma_rate")
        ms = min(cuda_ms(run, 5) for _ in range(2))
        flops = blocks * threads / 32 * iters * 8 * per_step * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32 {label}: {ms:.3f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s "
              f"({flops / ms / 1e9 / (TF32_OPS_PER_S / 1e12) * 100:.1f}% of "
              f"{TF32_OPS_PER_S / 1e12:.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
