#!/usr/bin/env python3
"""Where kernel K3's time goes: variants of ``roi_align.cu`` made by
textual edits, each timed in turns against its unedited source, on one GPU.

    git show <commit>:luminoth_tpu_torch/csrc/roi_align.cu \\
        > build/old_csrc/roi_align.cu
    python scripts/k3_variants.py --old build/old_csrc [--out F]

Of the earlier K3 (one thread per pooled output and channel, scalar
global atomics): ``atomics-stored`` (each atomic add a plain store),
``no-scatter`` (no add at all: a store of a value no sum reaches keeps
the work that feeds it), ``no-loads`` (each map load a value computed
from its index), and ``neither``. Of the current K3
(``luminoth_tpu_torch/csrc/roi_align.cu``): ``interleaved`` (blocks
alternate images instead of running image-major), ``one-block`` (220 KB
of shared memory, one block to an SM, wider slices), ``three-blocks``
(72 KB, three to an SM), ``four-blocks-of-128`` (128 threads and 54 KB,
four to an SM), ``scalar-flush`` (one scalar atomic per nonzero float
instead of one 16-byte atomic per nonzero float4), ``no-scatter`` (no
atomic into d_fm), and the phases left out one by one: ``no-gather``,
``no-route`` (the recompute and routing), ``gather-without-grid-loads``,
``no-stage`` (the copies), ``stage-only`` and ``nothing`` (taps, slices
and barriers alone). Each ``--alt`` source (another whole
``roi_align.cu`` with the same C interface) is timed against the current
one too. The variants that drop work compute something else; they show
what that work costs, and only the others are checked, against their
source, within check (b)'s tolerance (``chip_smoke.K3_TOL``).

Each runs at K3's train shape in bf16 on ``chip_smoke``'s random inputs
and on a train step's own (``compare_torch_kernels.k3_input_sets``),
timed source, variant, variant, source. Every source is built with the
port's ``nvcc`` flags plus ``-Xptxas -v``; the registers and spills of
K3 and the shared-memory atomics in its machine code are reported too.
It prints the card's name and power limit and one JSON line, and writes
the JSON to ``--out``. Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as smoke  # noqa: E402
import compare_torch_kernels as compare  # noqa: E402
from luminoth_tpu_torch import _build  # noqa: E402

PRELUDE_AT = "namespace {\n"
FLUSH = "atomicAdd(reinterpret_cast<float4*>(dst), sum);"
LOADS = (r"to_float\(fmi\[(.*?)\]\)", r"index_value(\1)", True)
# A store of a value no sum here reaches: the work that feeds it stays.
NEVER = "3.0e38f"


def prelude(text):
    return (PRELUDE_AT, PRELUDE_AT + text, False)


INDEX_VALUE = prelude(
    "__device__ __forceinline__ float index_value(int64_t i) {\n"
    "  return static_cast<float>((i * 40503) & 1023);\n}\n")
OLD_STORES = prelude("#define atomicAdd(p, v) (*(p) = (v))\n")
OLD_NO_SCATTER = prelude(
    "#define atomicAdd(p, v) do { const float v_ = (v); "
    f"if (v_ == {NEVER}) *(p) = v_; }} while (0)\n")
ROUTE = "    if (active) {\n      int py = first / p;"
GATHER = "    if (active) {\n      int r = first / cols;"
NO_ROUTE = [(ROUTE, ROUTE.replace("(active)", "(active && w < 0)"), False)]
NO_GATHER = [(GATHER, GATHER.replace("(active)", "(active && w < 0)"), False)]
NO_STAGE = [("busy ? vectors : 0", "0", False)]
NO_GRID_LOADS = [(
    "const float4 a = in[q * per_slice];",
    "const float4 a = make_float4(term.weight, 1.0f, 2.0f, 3.0f);", False)]
NO_FLUSH = [(FLUSH, f"if (sum.x == {NEVER} || sum.y == {NEVER} || "
             f"sum.z == {NEVER} || sum.w == {NEVER}) *dst = sum.x;", False)]
ONE_BLOCK = [("constexpr int kBackwardSmem = 108 * 1024;",
              "constexpr int kBackwardSmem = 220 * 1024;", False),
             ("__launch_bounds__(kBackwardThreads, 2)",
              "__launch_bounds__(kBackwardThreads, 1)", False)]

def blocks_per_sm(blocks, threads, kilobytes):
    return [("constexpr int kBackwardSmem = 108 * 1024;",
             f"constexpr int kBackwardSmem = {kilobytes} * 1024;", False),
            ("constexpr int kBackwardThreads = 256;",
             f"constexpr int kBackwardThreads = {threads};", False),
            ("__launch_bounds__(kBackwardThreads, 2)",
             f"__launch_bounds__(kBackwardThreads, {blocks})", False)]


# name: (source, [(old text or regex, new text, is_regex)], checked)
VARIANTS = {
    "old-atomics-stored": ("old", [OLD_STORES], False),
    "old-no-scatter": ("old", [OLD_NO_SCATTER], False),
    "old-no-loads": ("old", [INDEX_VALUE, LOADS], False),
    "old-neither": ("old", [OLD_NO_SCATTER, INDEX_VALUE, LOADS], False),
    "interleaved": ("new", [(
        "const int64_t roi = blockIdx.x;  // flat (image, roi) index, "
        "image-major",
        "const int64_t images = gridDim.x / rois;\n"
        "  const int64_t roi = (blockIdx.x % images) * rois + "
        "blockIdx.x / images;", False)], True),
    "one-block": ("new", ONE_BLOCK, True),
    "three-blocks": ("new", blocks_per_sm(3, 256, 72), True),
    "four-blocks-of-128": ("new", blocks_per_sm(4, 128, 54), True),
    "scalar-flush": ("new", [(
        FLUSH,
        "if (sum.x != 0.0f) atomicAdd(dst, sum.x);\n"
        "  if (sum.y != 0.0f) atomicAdd(dst + 1, sum.y);\n"
        "  if (sum.z != 0.0f) atomicAdd(dst + 2, sum.z);\n"
        "  if (sum.w != 0.0f) atomicAdd(dst + 3, sum.w);", False)], True),
    "no-scatter": ("new", NO_FLUSH, False),
    "no-gather": ("new", NO_GATHER, False),
    "gather-without-grid-loads": ("new", NO_GRID_LOADS, False),
    "no-route": ("new", NO_ROUTE, False),
    "no-stage": ("new", NO_STAGE, False),
    "stage-only": ("new", NO_ROUTE + NO_GATHER, False),
    "nothing": ("new", NO_ROUTE + NO_GATHER + NO_STAGE, False),
}


def edit(source, edits):
    for old, new, is_regex in edits:
        if not (re.search(old, source) if is_regex else old in source):
            raise ValueError(f"edit target not found: {old!r}")
        source = (re.sub(old, new, source) if is_regex
                  else source.replace(old, new))
    return source


def build(name, source, out_dir):
    """Compile ``source`` text as ``name``; return (library, ptxas report
    of K3, shared-memory atomic instructions in K3's machine code)."""
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(source)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
         cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    report = [
        lines[j].strip()
        for i, line in enumerate(lines)
        if "Compiling entry function" in line and "bwd" in line
        for j in range(i, min(i + 4, len(lines)))
    ]
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
         "-sass", so], capture_output=True, text=True).stdout
    atoms = {}
    function = None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[-1].strip()
        elif function and "bwd" in function:
            for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)"
                                 r"\.[A-Z0-9_.]+)", line):
                atoms[op] = atoms.get(op, 0) + 1
    lib = ctypes.CDLL(so)
    compare.declare_k3(lib)
    return lib, report, atoms


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", required=True,
                        help="directory holding the earlier roi_align.cu")
    parser.add_argument("--alt", nargs="*", default=[],
                        help="other roi_align.cu sources to time against "
                             "the current one")
    parser.add_argument("--out", help="write the JSON result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = smoke.card_line()
    print(card, flush=True)
    sources = {}
    for key, path in (("old", os.path.join(args.old, "roi_align.cu")),
                      ("new", str(_build.CSRC_DIR / "roi_align.cu"))):
        with open(path) as f:
            sources[key] = f.read()
    texts = dict(sources)
    variants = dict(VARIANTS)
    for name, (base, edits, _) in VARIANTS.items():
        texts[name] = edit(sources[base], edits)
    for path in args.alt:
        name = "alt-" + os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            texts[name] = f.read()
        variants[name] = ("new", [], True)
    out_dir = os.path.join(ROOT, "build", "k3_variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(
            lambda item: build(item[0], item[1], out_dir), texts.items())))
    compiled = {name: {"ptxas": b[1], "sass_atomics": b[2]}
                for name, b in built.items()}
    print(json.dumps(compiled), flush=True)

    inputs = compare.k3_input_sets(device)
    rows = []
    for set_name in ("random", "train-step"):
        fm32, boxes, g32, s = inputs[set_name]
        fm, grad = fm32.bfloat16(), g32.bfloat16()
        bound_ms, bound_by = smoke.k3_bound(fm, boxes, grad)

        def run(name):
            return compare.lib_k3(built[name][0], fm, boxes, grad, s)

        for name, (base, _, checked) in variants.items():
            if checked and not compare.within_k3_tol(run(name), run(base),
                                                     exact=False):
                raise AssertionError(f"{name} differs from {base} "
                                     f"({set_name})")
            means, times = compare.in_turns(lambda: run(base),
                                            lambda: run(name), 10, 2)
            rows.append({
                "inputs": set_name, "variant": name, "of": base,
                "dtype": "bfloat16", "variant_ms": means["new"],
                "source_ms": means["old"], "variant_turns_ms": times["new"],
                "source_turns_ms": times["old"],
                "source_minus_variant_ms": means["old"] - means["new"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "checked_within_tol": checked,
            })
            print(json.dumps(rows[-1]), flush=True)
    result = {"card": card, "compiled": compiled, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
