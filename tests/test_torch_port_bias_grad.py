"""The attention bias's gradient kernel (K7) around its launch, on the CPU,
and the C interface of every kernel library against its ctypes signature.

* the split of each cell's batch (``ops.attention.bias_grad_split``): a
  function of the per-cell batch alone, so a sweep round's cells are split
  as each cell alone; every element of a cell once, in order;
* the fp32 workspace of the partial tiles at the path's shapes;
* what ``_bias_grad_launch`` hands the C function, with a stand-in for the
  library: the split of the per-cell batch, the workspace, the argument
  kinds its signature names;
* every ``extern "C"`` function of ``csrc/*.cu`` against the argtypes of
  ``ops/attention.py::_SIGNATURES`` / ``_ERROR_STRING`` and
  ``ops/int8.py::_SIGNATURES``: its parameter count and kinds (pointer,
  int, float) and its result, so that a changed C interface fails here and
  not on the card.

The CUDA kernel itself runs only on the card (``chip_smoke.py``:
``bias_kernel_checks`` and ``bias_split_checks``); its arithmetic on the CPU
is the plain version's, held to the JAX package in ``test_torch_port_rpb.py``
and ``test_torch_port_swin.py``."""

import ctypes
import re
from types import SimpleNamespace

import pytest
import torch

from peft_vit_tpu_torch.ops import _build
from peft_vit_tpu_torch.ops import attention as attn
from peft_vit_tpu_torch.ops import int8


def _chunks(bias_batch):
    """The element indices of each chunk of a cell's batch."""
    per = attn.BIAS_GRAD_CHUNK
    return [list(range(i * per, min((i + 1) * per, bias_batch)))
            for i in range(attn.bias_grad_split(bias_batch))]


@pytest.mark.parametrize("bias_batch", [1, 5, 7, 8, 9, 13, 15, 16, 17, 31, 32, 33, 48, 63, 64,
                                        65, 96, 128, 191, 192, 193, 255, 256, 1000, 1024, 4096])
def test_split_covers_each_element_of_a_cell_once_in_order(bias_batch):
    """Chunks of at most ``BIAS_GRAD_CHUNK`` consecutive elements (the
    kernel takes at most 16), all full but the last, together the cell's
    batch in order; one chunk (dbias written directly) while the batch fits
    one."""
    chunks = _chunks(bias_batch)
    assert [e for chunk in chunks for e in chunk] == list(range(bias_batch))
    assert all(0 < len(c) <= attn.BIAS_GRAD_CHUNK <= 16 for c in chunks)
    assert len({len(c) for c in chunks[:-1]}) <= 1 and len(chunks[-1]) <= len(chunks[0])
    assert (len(chunks) == 1) == (bias_batch <= attn.BIAS_GRAD_CHUNK)


@pytest.mark.parametrize("cells", [2, 3, 7])
@pytest.mark.parametrize("b, n, d", [(16, 197, 64), (13, 197, 64), (64, 49, 32), (5, 25, 32)])
def test_split_of_a_round_is_each_cells_own(launch, cells, b, n, d):
    """A round of C cells folded into the batch (C B elements, a bias per
    cell) is launched with each cell's B elements split as the cell alone
    is: the same elements a chunk, the workspace C times the cell's."""
    alone, seen_alone = launch(b, 2, n, d, 1)
    folded, seen_folded = launch(cells * b, 2, n, d, cells)
    assert folded["chunk_elems"] == alone["chunk_elems"] == attn.BIAS_GRAD_CHUNK
    assert (folded["partial"] is None) == (alone["partial"] is None)
    if alone["partial"] is not None:
        chunks = seen_alone["empty"][-1][0]
        assert seen_alone["empty"][-1] == (chunks, 1, 2, n, n)
        assert seen_folded["empty"][-1] == (chunks, cells, 2, n, n)


@pytest.mark.parametrize("b, h, n, d, cells, mb", [
    (16, 12, 197, 64, 1, 0.0),   # ViT-B/16 RPB: one chunk, dbias written directly
    (48, 12, 197, 64, 3, 0.0),   # RPB's round of 3: one chunk a cell
    (64, 192, 49, 32, 1, 7.4),   # Swin-T stage 0 at B = 64: four chunks
    (64, 96, 49, 32, 1, 3.7),    # stage 1
    (64, 48, 49, 32, 1, 1.8),    # stage 2
    (64, 24, 49, 32, 1, 0.9),    # stage 3
    (192, 48, 49, 32, 3, 5.5),   # a Swin RPB round of 3 at stage 2
    (21, 12, 197, 64, 1, 3.7),   # 16 + 5
    (15, 12, 197, 64, 3, 0.0),   # cells of 5
])
def test_workspace_at_the_path_shapes(launch, b, h, n, d, cells, mb):
    """The fp32 workspace of the partial tiles, (chunks, C, H, N, N) at
    ``BIAS_GRAD_CHUNK`` = 16 elements a chunk (MB), or none where a cell's
    batch is one chunk: each launch allocates dbias, then the workspace."""
    assert attn.BIAS_GRAD_CHUNK == 16
    args, seen = launch(b, h, n, d, cells)
    shapes = seen["empty"][1:]  # after dbias
    if mb == 0.0:
        assert args["partial"] is None and shapes == []
        return
    chunks = -(-(b // cells) // 16)
    assert shapes == [(chunks, cells, h, n, n)]
    assert round(4 * chunks * cells * h * n * n / 1e6, 1) == mb


def test_split_refuses_what_the_kernel_does_not_take():
    for bias_batch in (0, -16):
        with pytest.raises(ValueError):
            attn.bias_grad_split(bias_batch)


class _Library:
    """A stand-in for the built library: records the call of
    ``attn_bias_grad`` and checks each argument's kind against the
    signature the wrapper sets."""

    def __init__(self):
        self.calls = []

    def attn_bias_grad(self, *args):
        kinds = attn._SIGNATURES["attn_bias_grad"]["attn_bias_grad"]
        assert len(args) == len(kinds)
        for arg, kind in zip(args, kinds):
            if kind is ctypes.c_void_p:
                assert arg is None or isinstance(arg, int)
            elif kind is ctypes.c_int:
                assert isinstance(arg, int)
            else:
                assert isinstance(arg, float)
        self.calls.append(args)
        return 0


@pytest.fixture
def launch(monkeypatch):
    """``_bias_grad_launch`` on CPU tensors with the library stood in for:
    returns the recorded arguments of the C call, named."""
    lib = _Library()
    monkeypatch.setattr(attn, "_kernel_library", lambda name: lib)
    monkeypatch.setattr(attn, "_check_kernel_operands", lambda *a, **k: None)
    monkeypatch.setattr(attn, "_device_index", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    seen = {}
    real_empty = torch.empty

    def empty(shape, **kw):
        t = real_empty(shape, **kw)
        seen.setdefault("empty", []).append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    names = ("device", "q", "k", "v", "dout", "o", "lse", "delta", "bias", "dbias", "partial",
             "B", "H", "N", "D", "C", "chunk_elems", "scale", "is_bf16", "stream")

    def run(b, h, n, d, cells, dtype=torch.bfloat16, from_o=False):
        q, k, v, do, o = (real_empty((b, h, n, d), dtype=dtype) for _ in range(5))
        lse, delta = real_empty((b, h, 1, n)), real_empty((b, h, 1, n))
        bias = real_empty((cells, h, n, n) if cells > 1 else (h, n, n))
        seen.clear()
        dbias = attn._bias_grad_launch(q, k, v, do, lse, 0.5, bias,
                                       None if from_o else delta, o if from_o else None)
        assert dbias.shape == bias.shape and dbias.dtype == torch.float32
        return dict(zip(names, lib.calls[-1])), dict(seen)

    return run


@pytest.mark.parametrize("b, cells", [(16, 1), (48, 3), (21, 1), (13, 1), (1, 1), (15, 3),
                                     (64, 1), (192, 3)])
def test_the_launch_gets_the_split_of_the_per_cell_batch(launch, b, cells):
    args, seen = launch(b, 12, 197, 64, cells)
    chunks = attn.bias_grad_split(b // cells)
    assert (args["B"], args["H"], args["N"], args["D"], args["C"]) == (b, 12, 197, 64, cells)
    assert args["chunk_elems"] == attn.BIAS_GRAD_CHUNK
    assert args["is_bf16"] == 1 and args["scale"] == 0.5
    assert (args["partial"] is None) == (chunks == 1)
    if chunks > 1:
        assert (chunks, cells, 12, 197, 197) in seen["empty"]


@pytest.mark.parametrize("b, h, cells", [(64, 48, 1), (16, 12, 1), (192, 48, 3)])
def test_the_launch_from_o_passes_o_and_no_delta(launch, b, h, cells):
    """Without delta the kernel computes it from o: o is handed on, delta
    is NULL, and the split and workspace are those with delta."""
    with_delta, seen_delta = launch(b, h, 49, 32, cells)
    args, seen = launch(b, h, 49, 32, cells, from_o=True)
    assert args["delta"] is None and args["o"] is not None
    assert with_delta["delta"] is not None and with_delta["o"] is None
    assert seen == seen_delta and args["chunk_elems"] == with_delta["chunk_elems"]


def test_the_fp32_launch_takes_no_workspace(launch):
    args, _ = launch(16, 12, 197, 64, 1, dtype=torch.float32)
    assert args["partial"] is None and args["is_bf16"] == 0


def _c_functions():
    """(library, function, result, [parameter kinds]) of every extern "C"
    function of ``csrc/*.cu``."""
    found = []
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C"\s+(const char\*|int)\s+(\w+)\s*\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            kinds = []
            for p in params:
                if "*" in p:
                    kinds.append("pointer")
                elif re.match(r"(const\s+)?float\b", p):
                    kinds.append("float")
                elif re.match(r"(const\s+)?int\b", p):
                    kinds.append("int")
                else:
                    kinds.append(f"unknown: {p}")
            found.append((src.stem, m.group(2), m.group(1), kinds))
    return found


C_FUNCTIONS = _c_functions()


def _declared(library, fn):
    """The (argtypes, restype) the wrappers set for ``fn`` of ``library``."""
    if library == "int8_gemm":
        return int8._SIGNATURES[fn]
    name, argtypes, restype = attn._ERROR_STRING
    if fn == name:
        return argtypes, restype
    return attn._SIGNATURES[library][fn], ctypes.c_int


def test_every_library_is_found():
    libraries = {lib for lib, *_ in C_FUNCTIONS}
    assert libraries == {s.stem for s in _build.CSRC_DIR.glob("*.cu")}
    assert libraries == set(attn._SIGNATURES) | {"int8_gemm"}
    for lib in attn._SIGNATURES:  # every signature names a function of its library
        assert set(attn._SIGNATURES[lib]) <= {fn for l, fn, *_ in C_FUNCTIONS if l == lib}
    assert set(int8._SIGNATURES) == {fn for l, fn, *_ in C_FUNCTIONS if l == "int8_gemm"}


@pytest.mark.parametrize("library, fn, result, kinds", C_FUNCTIONS,
                         ids=[f"{lib}.{fn}" for lib, fn, *_ in C_FUNCTIONS])
def test_c_interface_matches_its_ctypes_signature(library, fn, result, kinds):
    argtypes, restype = _declared(library, fn)
    kind_of = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    assert [kind_of[a] for a in argtypes] == kinds, f"{library}.{fn}"
    assert restype is (ctypes.c_char_p if result == "const char*" else ctypes.c_int)
