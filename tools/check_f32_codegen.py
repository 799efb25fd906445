#!/usr/bin/env python3
"""Compare the float32 kernels' machine code of two checkouts.

    python3 tools/check_f32_codegen.py --parent dist/parent [--sources ...]

Compiles each CUDA source of ``proxtv_tpu_torch/csrc`` in this checkout and
in ``--parent`` to a cubin for sm_90a (the flags of ``ops/kernels/build.py``,
all compiles at once), disassembles both with ``cuobjdump -sass``, pairs
each kernel of the parent with this checkout's float32 instantiation of it
(names demangled by ``cu++filt``; the name of a float32 instantiation of
a kernel templated on its scalar type is written as the untemplated
kernel's), and prints per kernel whether the instruction streams are the
same, or how many instructions differ in full and in their opcode alone
(a difference in registers only leaves the opcodes the same).  Kernels present in one checkout only are listed
apart (the float64 instantiations among them).  Exits 1 when a paired
kernel differs.  Needs ``nvcc``, ``cuobjdump`` and ``cu++filt`` (the CUDA
toolkit's ``bin``).
"""
import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from proxtv_tpu_torch.ops.kernels import build  # noqa: E402

DEFAULT = build.SOURCES  # every kernel


def tool(name):
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit(f"{name} not found")


def normalize(name):
    """A demangled kernel name with the scalar-type template argument of a
    float32 instantiation dropped and its templated types written as the
    untemplated code wrote them (``cu++filt`` writes a template's argument
    types as T1, T2, ...: the scalar type is T1)."""
    if re.search(r"<float[,>]", name):
        name = re.sub(r"\bT1\b", "float", name)
    if "<float>(" in name:  # was no template: no return type in its name
        name = re.sub(r"^void ", "", name)
    name = name.replace("direct1d::LamT<float>", "direct1d::Lam")
    name = re.sub(r"std::conditional<.*?Slot64>::type \*|float4 \*",
                  "float *", name)
    name = name.replace("<float, ", "<").replace("<float>(", "(")
    return name


def sass(cubin, filt):
    """{demangled name: [instruction text]} of a cubin."""
    out = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True,
                         capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = subprocess.run([filt, m.group(1)], capture_output=True,
                                 text=True).stdout.strip()
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur is not None and m:
            funcs[cur].append(" ".join(m.group(1).split()))
    return funcs


def compile_all(trees, sources, tmp):
    nvcc = tool("nvcc")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = []
    for tag, root in trees.items():
        for s in sources:
            src = os.path.join(root, "proxtv_tpu_torch", "csrc", s)
            if not os.path.exists(src):
                continue
            out = os.path.join(tmp, f"{tag}_{s}.cubin")
            jobs.append((tag, s, out, subprocess.Popen(
                [nvcc, *flags, "-cubin", src, "-o", out],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    done = {}
    for tag, s, out, p in jobs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {tag} {s}:\n{log}")
        done[(tag, s)] = out
    return done


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--sources", nargs="*", default=list(DEFAULT))
    ap.add_argument("--show", type=int, default=0,
                    help="print the first SHOW differing instructions of "
                         "each kernel that differs")
    args = ap.parse_args()
    filt = tool("cu++filt")
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        cubins = compile_all({"parent": args.parent, "change": REPO},
                             args.sources, tmp)
        for s in args.sources:
            if ("parent", s) not in cubins or ("change", s) not in cubins:
                print(f"[codegen] {s}: missing in one checkout")
                continue
            old = {normalize(k): v for k, v in
                   sass(cubins[("parent", s)], filt).items()}
            new_raw = sass(cubins[("change", s)], filt)
            new = {normalize(k): v for k, v in new_raw.items()
                   if "double" not in k}
            for name in sorted(old):
                if name not in new:
                    print(f"[codegen] {s}: {name}: not in this checkout")
                    continue
                a, b = old[name], new[name]
                n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a)
                                                                  - len(b))
                ops = (sum(x.split()[0] != y.split()[0]
                           for x, y in zip(a, b)) + abs(len(a) - len(b)))
                differ += n_diff > 0
                print(f"[codegen] {s}: {name}: "
                      + ("same instructions" if n_diff == 0 else
                         f"{n_diff} of {max(len(a), len(b))} instructions "
                         f"differ, {ops} in their opcode")
                      + f" ({len(a)} / {len(b)})")
                shown = 0
                for x, y in zip(a, b):
                    if x != y and shown < args.show:
                        print(f"    parent: {x}\n    change: {y}")
                        shown += 1
            for name in sorted(set(new_raw) - {k for k in new_raw
                                               if normalize(k) in old}):
                print(f"[codegen] {s}: only in this checkout: {name} "
                      f"({len(new_raw[name])} instructions)")
    print(f"[codegen] {differ} paired kernel(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
