"""Generate ``csrc/itx_1d.cuh``: the 1-D inverse transforms of
``ops/itx_1d.py`` as straight-line CUDA device functions.

    python3 -m dav1d_mirror_tpu_torch.tools.gen_itx_cuh [--check]

``ops/itx_1d.py`` runs on anything with +, -, *, >> and ``.clip``. This
script runs each of its functions once on symbolic values (``Sym``),
which record every operation instead of computing it, and writes the
recorded program as C: one device function per (family, length) pair that
``ops/itx.itx_families`` allows, and one for ``iwht4``. The kernel's
arithmetic is so, by construction, the sequence of operations that the
plain PyTorch path (and the JAX package) runs. Operations that no output
depends on are dropped. ``--check`` compares the committed header with
what the script would write and exits non-zero if they differ.

Each pair of length n >= 8 also gets zero-tail variants (``TAILS``): the
function with only its first m inputs live and the rest the constant 0,
for each m of 4, 8 and 16 below min(n, 32). A zero input is a ``Const``:
operations on constants only fold at generation time, in the same int32
wrap arithmetic, x + 0, x - 0 and 0 - x fold to x, x and -x, and a clip
of a constant folds to the constant where it lies inside every bit
depth's clip range. ``itx_line_<n>_tail`` dispatches on (family, m): the
kernel runs a block's column pass with the variant that covers its last
nonzero row (and its row pass with the one that covers its last nonzero
column).

Every +, -, * and unary - wraps as int32 two's complement does (torch,
numpy and XLA do that); the header does them in ``uint32_t`` because a
signed overflow is undefined in C++. ``>>`` is arithmetic on int32.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

from ..ops.itx import itx_families
from ..ops.itx_1d import get_1d_fn, iwht4

HEADER = os.path.join(os.path.dirname(__file__), os.pardir, "csrc",
                      "itx_1d.cuh")
# (family, line length); "wht" is the lossless 4-point Walsh-Hadamard
PAIRS = tuple((f, n) for n in (4, 8, 16, 32, 64)
              for f in itx_families(n)) + (("wht", 4),)
# live input counts of the zero-tail variants (those below min(n, 32))
TAILS = (4, 8, 16)
# (family, n, m): the zero-tail variants, m live inputs of min(n, 32)
TAIL_VARIANTS = tuple((f, n, m) for f, n in PAIRS if f != "wht"
                      for m in TAILS if m < min(n, 32))
# a clip of a constant folds where the constant lies inside every bit
# depth's clip range (ops/spec_consts.clip_ranges; the narrowest, 8 bpc)
CLIP_SAFE = (-32768, 32767)


def wrap32(v: int) -> int:
    """v as int32 two's complement."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


class Sym:
    """A value of a traced program: an input, an operation's result, or
    (as an argument) a Python int constant."""
    __slots__ = ("prog", "id")

    def __init__(self, prog, id_):
        self.prog = prog
        self.id = id_

    def _op(self, op, *args):
        return self.prog.emit(op, *args)

    def __add__(self, o):
        if _is_zero(o):
            return self
        return self._op("add", self, o)

    def __radd__(self, o):
        if _is_zero(o):
            return self
        return self._op("add", o, self)

    def __sub__(self, o):
        if _is_zero(o):
            return self
        return self._op("sub", self, o)

    def __rsub__(self, o):
        if _is_zero(o):
            return -self
        return self._op("sub", o, self)

    def __mul__(self, o):
        if isinstance(o, Const):
            o = o.v
        if not isinstance(o, int):
            raise TypeError("only products with a constant are traced")
        return self._op("mul", self, o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __neg__(self):
        return self._op("neg", self)

    def __rshift__(self, k):
        if not isinstance(k, int):
            raise TypeError("only shifts by a constant are traced")
        return self._op("shr", self, k)

    def clip(self, mn, mx):
        assert (mn, mx) == ("mn", "mx"), (mn, mx)
        return self._op("clip", self)


class Const:
    """A traced value known at generation time: a zero-tail input, or an
    operation on constants only, folded in int32 wrap arithmetic. With a
    Sym operand it records the operation (with the constant as an
    argument) in that Sym's program."""
    __slots__ = ("prog", "v")

    def __init__(self, prog, v):
        self.prog = prog
        self.v = wrap32(v)

    def _val(self, o):
        if isinstance(o, Const):
            return o.v
        if isinstance(o, int):
            return o
        raise TypeError(f"cannot trace {type(o).__name__}")

    def __add__(self, o):
        if isinstance(o, Sym):
            return o.__radd__(self)
        return Const(self.prog, self.v + self._val(o))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Sym):
            return o.__rsub__(self)
        return Const(self.prog, self.v - self._val(o))

    def __rsub__(self, o):
        return Const(self.prog, self._val(o) - self.v)

    def __mul__(self, o):
        if isinstance(o, Sym):
            return o * self
        return Const(self.prog, self.v * self._val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Const(self.prog, -self.v)

    def __rshift__(self, k):
        if not isinstance(k, int):
            raise TypeError("only shifts by a constant are traced")
        return Const(self.prog, self.v >> k)

    def clip(self, mn, mx):
        assert (mn, mx) == ("mn", "mx"), (mn, mx)
        if CLIP_SAFE[0] <= self.v <= CLIP_SAFE[1]:
            return self
        return self.prog.emit("clip", self)


def _is_zero(o):
    return (isinstance(o, Const) and o.v == 0) or \
        (isinstance(o, int) and not isinstance(o, bool) and o == 0)


class Program:
    """A straight-line program: values 0 .. n_in - 1 are its inputs, value
    n_in + i is the result of ops[i] = (op, args), each argument ("v",
    value id) or ("c", constant); outputs are value ids."""

    def __init__(self, n_in):
        self.n_in = n_in
        self.ops = []          # (op, args); value id = n_in + index
        self.outputs = []

    def inputs(self):
        return [Sym(self, k) for k in range(self.n_in)]

    def emit(self, op, *args):
        enc = []
        for a in args:
            if isinstance(a, Sym):
                enc.append(("v", a.id))
            elif isinstance(a, Const):
                enc.append(("c", a.v))
            elif isinstance(a, int):
                enc.append(("c", a))
            else:
                raise TypeError(f"cannot trace {type(a).__name__}")
        self.ops.append((op, tuple(enc)))
        return Sym(self, self.n_in + len(self.ops) - 1)


def trace(family: str, n: int, m: int | None = None) -> Program:
    """The program of one (family, n) pair, dead operations dropped and
    value ids renumbered in order; with m, its zero-tail variant (inputs
    m .. min(n, 32) - 1 the constant 0). An output is a value id, or
    ("c", value) where it folded to a constant."""
    n_in = min(n, 32) if m is None else m
    prog = Program(n_in)
    ins = prog.inputs() + [Const(prog, 0)] * (min(n, 32) - n_in)
    if family == "wht":
        outs = iwht4(ins)
    else:
        outs = get_1d_fn(family, n)(ins, "mn", "mx")
    assert len(outs) == n, (family, n, len(outs))
    # dead-code elimination, then renumbering
    live = set(o.id for o in outs if isinstance(o, Sym))
    for idx in range(len(prog.ops) - 1, -1, -1):
        if prog.n_in + idx in live:
            live.update(a[1] for a in prog.ops[idx][1] if a[0] == "v")
    new_id = {k: k for k in range(n_in)}
    out = Program(n_in)
    for idx, (op, args) in enumerate(prog.ops):
        if prog.n_in + idx not in live:
            continue
        new_id[prog.n_in + idx] = n_in + len(out.ops)
        out.ops.append((op, tuple(("v", new_id[a[1]]) if a[0] == "v" else a
                                  for a in args)))
    out.outputs = [new_id[o.id] if isinstance(o, Sym) else ("c", o.v)
                   for o in outs]
    return out


@functools.lru_cache(maxsize=None)
def op_count(family: str, n: int, m: int | None = None) -> int:
    """Arithmetic operations of one line of the pair, or of its zero-tail
    variant with m live inputs (loads and stores not counted; a clip
    counts as one)."""
    return len(trace(family, n, m).ops)


def tail_inputs(need: int, n: int) -> int:
    """Live inputs of the variant that a line of length n runs when its
    inputs from `need` on are zero: the least m of TAILS with need <= m <
    min(n, 32), else min(n, 32) (the full function). The kernel's copy is
    itx_tail_inputs in the header."""
    for m in TAILS:
        if need <= m < min(n, 32):
            return m
    return min(n, 32)


def fn_name(family: str, n: int, m: int | None = None) -> str:
    return f"itx_{family}_{n}" + ("" if m is None else f"_in{m}")


def _arg(a):
    return f"v{a[1]}" if a[0] == "v" else str(a[1])


def render_fn(family: str, n: int, m: int | None = None) -> str:
    p = trace(family, n, m)
    sig = (f"__device__ __forceinline__ void {fn_name(family, n, m)}("
           f"const int32_t* in, int32_t* out, int32_t mn, int32_t mx)")
    live = (f"{p.n_in} inputs" if m is None else
            f"{m} of {min(n, 32)} inputs live (the rest 0)")
    lines = [f"// {family}, {live}, {n} outputs, {len(p.ops)} "
             f"operations", sig + " {"]
    lines += [f"    const int32_t v{k} = in[{k}];" for k in range(p.n_in)]
    for idx, (op, args) in enumerate(p.ops):
        call = ", ".join([_arg(a) for a in args] +
                         (["mn", "mx"] if op == "clip" else []))
        lines.append(
            f"    const int32_t v{p.n_in + idx} = itx_{op}({call});")
    lines += [f"    out[{k}] = " + (f"v{v}" if isinstance(v, int) else
                                    str(v[1])) + ";"
              for k, v in enumerate(p.outputs)]
    lines.append("}")
    return "\n".join(lines)


PRELUDE = """\
// Generated by dav1d_mirror_tpu_torch/tools/gen_itx_cuh.py from
// dav1d_mirror_tpu_torch/ops/itx_1d.py; do not edit. Regenerate with
//     python3 -m dav1d_mirror_tpu_torch.tools.gen_itx_cuh
//
// The 1-D inverse transforms as straight-line device functions, one per
// (family, line length) of ops/itx.itx_families and one for iwht4:
// in[] holds min(n, 32) inputs, out[] receives n outputs, and every
// butterfly that clips clips to [mn, mx]. +, -, * and unary - wrap as
// int32 two's complement (done in uint32_t: a signed overflow is undefined
// in C++); >> is arithmetic.
#pragma once
#include <stdint.h>

__device__ __forceinline__ int32_t itx_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t itx_neg(int32_t a) {
    return (int32_t)(0u - (uint32_t)a);
}
__device__ __forceinline__ int32_t itx_shr(int32_t a, int k) {
    return a >> k;
}
__device__ __forceinline__ int32_t itx_clip(int32_t a, int32_t mn,
                                            int32_t mx) {
    return min(max(a, mn), mx);
}
"""


def _family_switch(n: int, m: int | None, indent: str) -> list:
    fams = itx_families(n)
    lines = [f"{indent}switch (fam) {{"]
    for i, f in enumerate(fams[1:], 1):
        lines.append(f"{indent}case {i}: {fn_name(f, n, m)}(in, out, mn, "
                     "mx); break;")
    lines += [f"{indent}default: {fn_name(fams[0], n, m)}(in, out, mn, mx); "
              "break;", f"{indent}}}"]
    return lines


def render_line(n: int) -> str:
    """The dispatch of one line length: family index i of
    ops/itx.itx_families(n) runs that family; any other index runs
    family 0, so a bad selector reads nothing out of bounds."""
    fams = itx_families(n)
    lines = [f"// family index i of itx_families({n}) = {fams}; any other "
             "index runs family 0",
             f"__device__ __forceinline__ void itx_line_{n}(int fam, "
             "const int32_t* in, int32_t* out,",
             "                                              int32_t mn, "
             "int32_t mx) {"]
    lines += _family_switch(n, None, "    ") + ["}"]
    return "\n".join(lines)


def render_tail(n: int) -> str:
    """The zero-tail dispatch of one line length: in[] holds the first m
    inputs (m = itx_tail_inputs(need, n)), the rest are 0."""
    tails = [m for m in TAILS if m < min(n, 32)]
    lines = [f"// itx_line_{n} with only in[0 .. m - 1] live (the rest 0), "
             f"m = itx_tail_inputs(need, {n}): "
             + (f"the variants of m = {tails}, else " if tails else "")
             + "the full function",
             f"__device__ __forceinline__ void itx_line_{n}_tail(int fam, "
             "int m, const int32_t* in,",
             "                                                   int32_t* "
             "out, int32_t mn, int32_t mx) {"]
    for m in tails:
        lines.append(f"    if (m == {m}) {{")
        lines += _family_switch(n, m, "        ")
        lines.append("        return;")
        lines.append("    }")
    lines.append(f"    itx_line_{n}(fam, in, out, mn, mx);")
    lines.append("}")
    return "\n".join(lines)


def render_tail_inputs() -> str:
    """tail_inputs as a C expression (every m of TAILS is below 32, so
    m < min(n, 32) is m < n)."""
    expr = "(n < 32 ? n : 32)"
    for m in reversed(TAILS):
        expr = f"(need <= {m} && {m} < n) ? {m}\n           : {expr}"
    return "\n".join([
        "// the live inputs of the zero-tail variant that a line of length "
        "n runs",
        "// when its inputs from `need` on are 0 "
        "(tools/gen_itx_cuh.tail_inputs)",
        "__host__ __device__ __forceinline__ constexpr int "
        "itx_tail_inputs(int need, int n) {",
        f"    return {expr};", "}"])


def render() -> str:
    return PRELUDE + "\n" + "\n\n".join(
        [render_fn(f, n) for f, n in PAIRS] +
        [render_fn(f, n, m) for f, n, m in TAIL_VARIANTS] +
        [render_line(n) for n in (4, 8, 16, 32, 64)] +
        [render_tail_inputs()] + [render_tail(n) for n in (4, 8, 16, 32, 64)]) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the committed header, write nothing")
    opts = ap.parse_args(argv)
    text = render()
    if opts.check:
        with open(HEADER) as f:
            same = f.read() == text
        print("csrc/itx_1d.cuh is " + ("up to date" if same else "STALE"))
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {os.path.normpath(HEADER)}: {len(PAIRS)} functions, "
          f"{sum(op_count(f, n) for f, n in PAIRS)} operations; "
          f"{len(TAIL_VARIANTS)} zero-tail variants, "
          f"{sum(op_count(*v) for v in TAIL_VARIANTS)} operations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
