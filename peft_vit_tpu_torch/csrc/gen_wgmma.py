"""Write ``wgmma_sm90.cuh``: the Hopper warpgroup products the hand-written
kernels issue (the forward mainloop of K1 and K4, the backward mainloops of
K2, K3 and K5, the int8 GEMM K6), one inline-PTX function per shape.

    python3 peft_vit_tpu_torch/csrc/gen_wgmma.py     # rewrites the header

A ``wgmma`` instruction names every accumulator register, so each width n
needs its own asm statement; this script spells them out instead of a
preprocessor maze.  Emitted:

* ``wgmma_ss<n>(d, desc_a, desc_b, scale_d)`` for n = 8, 16, ..., 256:
  ``m64n{n}k16`` bf16 x bf16 -> fp32, A and B from shared memory, both
  K-major (S = Q K^T; in the backward also dP = dO V^T, S^T = K Q^T and
  dP^T = V dO^T, n = 8 to 64 for a chunk cut to its rows);
* ``wgmma_rs_n{n}_tb(d, a, desc_b, scale_d)`` for n in ``RS_WIDTHS`` (the
  head dims 32 and 64): ``m64n{n}k16`` with A from registers and B MN-major
  (O += P V, V stored key-major; in the backward dq += dS K, dv += P^T dO
  and dk += dS^T Q);
* ``wgmma_ss_s8<n>(d, desc_a, desc_b, scale_d)`` for the widths in
  ``S8_WIDTHS``: ``m64n{n}k32`` s8 x s8 -> s32, A and B from shared memory,
  both K-major (K6: the quantized rows times the int8 weight).  The integer
  form takes no scale or transpose immediates: its operands are K-major
  only.

``tests/test_torch_port_attention.py`` checks that the committed header is
this script's output.
"""

from __future__ import annotations

from pathlib import Path

HEADER = Path(__file__).resolve().parent / "wgmma_sm90.cuh"
WIDTHS = tuple(range(8, 257, 8))
RS_WIDTHS = (32, 64)  # the head dims of the attention kernels
S8_WIDTHS = (64,)  # K6: one warpgroup's 64 columns of a 128-column tile


def _regs(first: int, count: int) -> str:
    """``%first, ..., %(first + count - 1)``, eight to a string literal."""
    names = [f"%{first + i}" for i in range(count)]
    rows = [", ".join(names[i:i + 8]) for i in range(0, count, 8)]
    return ', "\n      "'.join(rows)


def _outputs(count: int, kind: str = "f") -> str:
    outs = [f'"+{kind}"(d[{i}])' for i in range(count)]
    return ",\n        ".join(", ".join(outs[i:i + 8]) for i in range(0, count, 8))


def _ss(n: int) -> str:
    r = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{r}], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outputs(r)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""__device__ __forceinline__ void wgmma_rs_n{n}_tb(float (&d)[{r}], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(0, r)}}}, {{{_regs(r, 4)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outputs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}}
"""


def _ss_s8(n: int) -> str:
    r = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss_s8<{n}>(int (&d)[{r}], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{_regs(0, r)}}}, %{r}, %{r + 1}, p;\\n}}\\n"
      : {_outputs(r, "r")}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
"""


def render() -> str:
    parts = [
        "// Generated by gen_wgmma.py in this directory; edit that script, not this file.\n"
        "//\n"
        "// Hopper warpgroup products (sm_90a) for the attention kernels (K1 to K5)\n"
        "// and the int8 GEMM (K6, int8_gemm.cu).\n"
        "// Every call must be made by all 128 threads of a warpgroup, between\n"
        "// wgmma.fence and wgmma.commit_group / wait_group (attn_fwd_sm90.cuh,\n"
        "// attn_bwd_sm90.cuh, int8_gemm.cu).\n"
        "// scale_d = 0 overwrites d, 1 accumulates into it.\n"
        "\n"
        "#pragma once\n"
        "\n"
        "#include <stdint.h>\n"
        "\n"
        "namespace sm90 {\n"
        "\n"
        "// m64n{N}k16 bf16 x bf16 -> fp32; A and B from shared memory, K-major.\n"
        "template <int N>\n"
        "__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,\n"
        "                                         int scale_d);\n"
        "\n"
    ]
    parts += [_ss(n) + "\n" for n in WIDTHS]
    parts.append("// m64n{N}k16 bf16 x bf16 -> fp32; A from registers (the m16n8k16 A fragment\n"
                 "// of each warp's 16 rows), B from shared memory, MN-major.\n")
    parts.append("\n".join(_rs(n) for n in RS_WIDTHS))
    parts.append("\n// m64n{N}k32 s8 x s8 -> s32; A and B from shared memory, K-major.\n"
                 "template <int N>\n"
                 "__device__ __forceinline__ void wgmma_ss_s8(int (&d)[N / 2], uint64_t desc_a,\n"
                 "                                            uint64_t desc_b, int scale_d);\n\n")
    parts += [_ss_s8(n) + "\n" for n in S8_WIDTHS]
    parts.append("}  // namespace sm90\n")
    return "".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
