"""K5's causal mode before and after a change, on the card: each tree's
flash-attention kernel built and timed in a process of its own, in the
order old, new, new, old, then the SASS of the causal (no-window)
kernels of the two builds compared.

    python tools/flash_window_ab.py OLD_TREE NEW_TREE

A tree is a checkout of the repo (``git archive`` of a commit unpacked
into a git-ignored directory such as ``build/``).  Times are ms a call
(CUDA events, 10 calls after a warm-up, three such runs) of
``flash_attention_cuda`` at [11]'s bfloat16 shapes (2, 32768, 24/8, dh
128 and 64) and gemma3's local shape (1, 32768, 32/16, 128), causal, and
with window 1,024 where the tree's wrapper takes one.  The SASS of each
causal kernel is compared after normalising constant-bank offsets and
branch targets (a new field of ``Params`` moves the former).
"""
import collections
import difflib
import glob
import re
import subprocess
import sys
from pathlib import Path

SHAPES = ((2, 32768, 24, 8, 128), (2, 32768, 24, 8, 64),
          (1, 32768, 32, 16, 128))


def time_tree(tree: str, label: str) -> None:
    """Build ``tree``'s K5 and print its times (run in a child)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels.flashattn import kernel as fk
    fk.library()

    def ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    windowed = "window" in fk.flash_attention_cuda.__code__.co_varnames
    out = []
    for b, s, h, kv, dh in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, s, n, dh, generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (h, kv, kv))
        row = [ms(lambda: fk.flash_attention_cuda(q, k, v))
               for _ in range(3)]
        text = f"{(b, s, h, kv, dh)}: " + ", ".join(f"{x:.3f}" for x in row)
        if windowed:
            row = [ms(lambda: fk.flash_attention_cuda(q, k, v, window=1024))
                   for _ in range(3)]
            text += " | window 1024: " + ", ".join(f"{x:.3f}" for x in row)
        out.append(text)
    print(label, tree, "|", " || ".join(out), flush=True)


def sass(tree: str) -> dict:
    """function -> its normalised SASS lines, from ``tree``'s build."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import cuobjdump_path
    lib = glob.glob(str(Path(tree) / "build" / "kernels" / "flashattn-*.so"))
    text = subprocess.run([cuobjdump_path(), "-sass", lib[0]],
                          capture_output=True, text=True, check=True).stdout
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = insn.search(line)
            if m:
                x = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[]", m.group(1))
                out[name].append(re.sub(r"BRA 0x[0-9a-f]+", "BRA", x))
    return out


def compare(old: str, new: str) -> None:
    """Each causal kernel's SASS: the old build's (one template argument,
    or the window flag false) against the new one's."""
    a, b = sass(old), sass(new)
    for kind, dh in (("bf16", 64), ("bf16", 128), ("f32", 16), ("f32", 64),
                     ("f32", 128)):
        def pick(funcs):
            names = [k for k in funcs if f"flash_{kind}_kernelILi{dh}E" in k
                     and "Lb1E" not in k]
            return funcs[names[0]]
        fa, fb = pick(a), pick(b)
        diff = [x for x in difflib.unified_diff(fa, fb, lineterm="", n=0)
                if x[:1] in "+-" and x[:3] not in ("+++", "---")]
        ha = collections.Counter(x.split()[0] for x in fa)
        hb = collections.Counter(x.split()[0] for x in fb)
        moved = {k: hb[k] - ha[k] for k in set(ha) | set(hb) if ha[k] != hb[k]}
        print(f"{kind}<{dh}> causal: {len(fa)} instructions old, {len(fb)} "
              f"new; identical {fa == fb}; {len(diff)} lines differ; opcode "
              f"counts moved {moved}", flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        time_tree(sys.argv[2], sys.argv[3])
        return
    old, new = sys.argv[1:3]
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for tree, label in ((old, "old1"), (new, "new1"), (new, "new2"),
                        (old, "old2")):
        subprocess.run([sys.executable, __file__, "--time", tree, label],
                       check=True)
    compare(old, new)


if __name__ == "__main__":
    main()
