"""The ctypes table of the port's kernels (``ops/kernels.py`` ``_ARGTYPES``)
against the C entries of ``csrc/*.cu``, read as text (no ``nvcc``).

A pointer or a ``long long`` that ctypes passes as a 32-bit ``int`` is cut
on the card only; this holds every entry's parameters to the table here.
"""

import ctypes
import re

import pytest

from fortran_davidson_tpu_torch.ops import kernels

_BLOCK = re.compile(r'extern "C" \{(.*?)\}\s*// extern "C"', re.S)
_FUNC = re.compile(r"^int\s+(fdt_\w+)\s*\(([^)]*)\)\s*\{", re.S | re.M)


def _entries() -> dict:
    """name -> [parameter declarations] of every extern "C" entry."""
    out = {}
    for src in kernels.sources():
        for block in _BLOCK.findall(src.read_text()):
            for name, params in _FUNC.findall(block):
                out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


ENTRIES = _entries()


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    if param.startswith("long long"):
        return "long long"
    assert re.match(r"int \w+$", param), f"unexpected parameter {param!r}"
    return "int"


def _is_pointer(t) -> bool:
    return t is ctypes.c_void_p or (isinstance(t, type)
                                    and issubclass(t, ctypes._Pointer))


def test_every_table_entry_has_a_source():
    assert ENTRIES, "no extern \"C\" entry found under csrc/"
    assert sorted(set(kernels._ARGTYPES) - set(ENTRIES)) == []


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_table_matches_the_c_entry(name):
    assert name in kernels._ARGTYPES, f"{name} has no ctypes entry"
    params = ENTRIES[name]
    types = kernels._ARGTYPES[name]
    assert len(types) == len(params), (name, params, types)
    for param, t in zip(params, types):
        kind = _kind(param)
        if kind == "pointer":
            assert _is_pointer(t), (name, param, t)
        elif kind == "long long":
            assert t is ctypes.c_longlong, (name, param, t)
        else:
            assert t is ctypes.c_int, (name, param, t)
