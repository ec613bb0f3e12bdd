"""The ctypes tables of the port's kernel wrappers against the C entry points
they bind, read from ``gnn_computing_tpu_torch/csrc/<name>.cu`` on the CPU.

ctypes passes each argument as its table says, whatever the C function
takes: a table one argument short or with an int where the entry takes a
pointer still loads and launches on the card, with every later argument
misplaced.  So each table entry is held here to its ``extern "C"``
declaration (expanded from its ``##tag##`` macro where it has one), and
that macro must be instantiated for the entry's tag."""

import ctypes
import pathlib
import re

import pytest

from gnn_computing_tpu_torch.ops import cuda_bcsr, cuda_gat, cuda_gat_bwd, cuda_residual, cuda_rowmax, cuda_sddmm

CSRC = pathlib.Path(cuda_bcsr.__file__).resolve().parent.parent / "csrc"
TABLES = [
    (cuda_bcsr.NAME, cuda_bcsr.SIGNATURES),
    (cuda_gat.NAME, cuda_gat.SIGNATURES),
    (cuda_gat.FACTORED_NAME, cuda_gat.FACTORED_SIGNATURES),
    (cuda_gat_bwd.DAD, cuda_gat_bwd.DAD_SIGNATURES),
    (cuda_gat_bwd.DH_DAS, cuda_gat_bwd.DH_DAS_SIGNATURES),
    (cuda_residual.RESIDUAL, cuda_residual.RESIDUAL_SIGNATURES),
    (cuda_residual.TASK_SUMS, cuda_residual.TASK_SUMS_SIGNATURES),
    (cuda_residual.FUSED, cuda_residual.FUSED_SIGNATURES),
    (cuda_rowmax.NAME, cuda_rowmax.SIGNATURES),
    (cuda_sddmm.NAME, cuda_sddmm.SIGNATURES),
]
ENTRIES = [(lib, sym, args) for lib, table in TABLES for sym, args in table.items()]
ENTRY = re.compile(r'extern\s+"C"\s+int\s+([\w#]+)\s*\(([^)]*)\)')


def _ctype(decl: str):
    """The ctypes type of one C parameter declaration."""
    words = decl.replace("*", " * ").split()[:-1]  # drop the parameter's name
    if "*" in words:
        return ctypes.c_void_p
    return {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong, ("float",): ctypes.c_float}[tuple(words)]


def _entries(lib: str):
    """[(symbol regex, macro or None, [ctypes types])] of csrc/<lib>.cu's
    extern "C" functions, macro continuations joined."""
    src = (CSRC / f"{lib}.cu").read_text().replace("\\\n", " ")
    out = []
    for m in ENTRY.finditer(src):
        name, params = m.groups()
        pattern = re.sub(r"##\w+##", r"([a-z0-9]+)", name)  # a tag: i8, b1, f32, bf16
        macro = re.findall(r"#define\s+(\w+)\(", src[: m.start()])
        out.append((pattern, macro[-1] if "##" in name else None, [_ctype(p) for p in params.split(",")], src))
    return out


@pytest.mark.parametrize("lib,sym,args", ENTRIES, ids=[sym for _, sym, _ in ENTRIES])
def test_ctypes_table_matches_c_entry(lib, sym, args):
    found = [(re.fullmatch(p, sym), macro, types, src) for p, macro, types, src in _entries(lib)]
    found = [f for f in found if f[0]]
    assert len(found) == 1, f"{sym}: {len(found)} extern \"C\" entries in csrc/{lib}.cu match"
    match, macro, types, src = found[0]
    assert args == types, f"{sym}: table {args} against csrc/{lib}.cu's {types}"
    if macro is not None:
        assert re.search(rf"\b{macro}\(\s*{match.group(1)}\s*,", src), f"{sym}: {macro} not instantiated"
