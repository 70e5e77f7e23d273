"""Folded UDF-decoder evaluation: the grid-fill, gradient-free hot op.

At inference every conditional batch norm is an affine with constants
(running statistics plus the latent-conditioned γ/β), so for one latent the
CbnDecoder folds into a plain MLP:

    x₀ = posenc(p) @ W_in + b_in
    per block: x ← x + W₂ᵀ·relu(a₂⊙(W₁ᵀ·relu(a₁⊙x + c₁) + b₁) + c₂)
    udf = (1 − σ(w_outᵀ·relu(a_out⊙x + c_out) + b_out)) · max_dist

Kernel K1 evaluates it; it replaces the TPU kernel `_decoder_kernel` /
`pallas_folded_udf` (surfd_tpu/ops/decoder_kernel.py, retired in commit
a9ab519). Both precisions run on wgmma tensor cores. Precision "f32" runs
`ops/csrc/folded_mlp.cu` (3xTF32: each operand split into two tf32 halves,
three products, f32 sums) and matches the live JAX function `folded_udf`;
precision "bf16" runs `ops/csrc/folded_mlp_bf16.cu` (bf16 matmul inputs, f32
sums, f32 affine/ReLU chain — the retired TPU kernel's own math) and matches
`folded_udf_mixed`. The plain versions below are those two functions. The
source notes in the .cu files say what bounds each on an H100 and how the
design answers.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import torch

from . import _build

NUM_FREQS = 10


@dataclass
class FoldedDecoder:
    """Inference-folded decoder weights for one latent, all on one device.

    K1's packed operands (`packed`) are cached on the fold and made again
    when a field is replaced or a tensor is changed in place."""

    w_in: torch.Tensor  # (63, H)
    b_in: torch.Tensor  # (H,)
    a1: torch.Tensor  # (L, H) per-block affines and biases
    c1: torch.Tensor
    w1: torch.Tensor  # (L, H, H)
    b1: torch.Tensor
    a2: torch.Tensor
    c2: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    a_out: torch.Tensor  # (H,)
    c_out: torch.Tensor
    w_out: torch.Tensor  # (H, 1)
    b_out: torch.Tensor  # (1,)
    max_dist: float
    b_out_value: float = 0.0  # b_out on the host: no device read per launch
    # K1's operands per precision, each beside the `_sources` they were made
    # from; a copy (dataclasses.replace, padded) starts with none
    _packed: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def hidden(self) -> int:
        return self.w_in.shape[1]

    @property
    def layers(self) -> int:
        return self.w1.shape[0]

    def padded(self, width: int) -> FoldedDecoder:
        """Copy with the hidden width zero-padded to `width`. Zero weights,
        biases and affines keep every padded unit exactly 0 through each
        ReLU, so the result does not change."""
        H = self.hidden
        if width < H:
            raise ValueError(f"cannot pad hidden width {H} down to {width}")

        def pad(t: torch.Tensor, *dims: int) -> torch.Tensor:
            out = t.new_zeros(tuple(width if d in dims else n for d, n in enumerate(t.shape)))
            out[tuple(slice(0, n) for n in t.shape)] = t
            return out

        return FoldedDecoder(
            w_in=pad(self.w_in, 1), b_in=pad(self.b_in, 0),
            a1=pad(self.a1, 1), c1=pad(self.c1, 1), w1=pad(self.w1, 1, 2), b1=pad(self.b1, 1),
            a2=pad(self.a2, 1), c2=pad(self.c2, 1), w2=pad(self.w2, 1, 2), b2=pad(self.b2, 1),
            a_out=pad(self.a_out, 0), c_out=pad(self.c_out, 0), w_out=pad(self.w_out, 0),
            b_out=self.b_out, max_dist=self.max_dist, b_out_value=self.b_out_value,
        )

    def _sources(self) -> tuple:
        """What K1's operands are made from: every field, and each tensor's
        in-place version (`Tensor._version`, shared with its views)."""
        values = tuple(getattr(self, f.name) for f in fields(self) if f.name != "_packed")
        return values, tuple(v._version for v in values if isinstance(v, torch.Tensor))

    def packed(self, precision: str) -> PackedK1:
        """K1's operands for `precision` (`pack_k1`), cached until a field is
        replaced or a tensor changed in place."""
        values, versions = self._sources()
        hit = self._packed.get(precision)
        if hit is None or hit[1] != versions or any(a is not b for a, b in zip(hit[0], values)):
            hit = self._packed[precision] = (values, versions, pack_k1(self, precision))
        return hit[2]


K1_WIDTHS = (64, 128, 256, 512)  # hidden widths both K1 kernels instantiate
SLAB_K = 64  # K rows of one weight slab that K1 bf16 streams


def pass_width(width: int) -> int:
    """Output columns of one K1 bf16 pass: both warpgroups, half each."""
    return min(256, width)


def pack_kmajor(w: torch.Tensor, npass: int) -> torch.Tensor:
    """Pack a (K, N) matmul weight (x @ w) into wgmma's no-swizzle K-major
    core-matrix layout, as a flat bf16 tensor (K1 bf16). K is a multiple of
    64, N of `npass`.

    With k = 64·s + 8·kg + kk and n = npass·p + 8·ng + nn (kk, nn < 8), the
    element w[k, n] lands at

        offset = (p·(K/64) + s)·npass·64 + (8·ng + kg)·64 + 8·nn + kk

    so the slab (p, s) — 64 K rows by the npass columns of pass p — is one
    contiguous block of npass·128 bytes, stored pass-major, slab-minor in the
    order the kernel streams them. Inside a slab each core matrix (8 rows of
    n, 16 bytes of k) is 128 contiguous bytes, ordered [ng][kg]: the
    descriptor's leading byte offset (next core matrix along K) is 128 bytes
    and its stride byte offset (next 8 rows of N) is 8·128 = 1024 bytes.
    """
    K, N = w.shape
    if K % SLAB_K or N % npass or npass % 8:
        raise ValueError(f"cannot pack a ({K}, {N}) weight in passes of {npass}")
    t = w.to(torch.bfloat16).reshape(K // SLAB_K, 8, 8, N // npass, npass // 8, 8)
    return t.permute(3, 0, 4, 1, 5, 2).contiguous().reshape(-1)  # [p, s, ng, kg, nn, kk]


AFRAG_K = 16  # K rows of one weight slab that K1 f32 streams: two k8 steps


def pack_afrag(w: torch.Tensor) -> torch.Tensor:
    """Pack a (K, N) matmul weight (x @ w) for K1 f32, which multiplies
    wᵀ (N × K, the hidden units as wgmma's M) as the register A operand of
    m64nNk8 tf32 wgmmas. A flat f32 tensor; K is a multiple of 16, N of 64.

    In an m64nNk8 tf32 A fragment, thread tt = 32·w + 4·g + t of the
    warpgroup holds, in its registers v = 2·vk + vm, the element of row
    16·w + 8·vm + g and column 4·vk + t. So with k = 16·s + 8·q + 4·vk + t
    and n = 64·j + 16·w + 8·vm + g, the element w[k, n] lands at

        offset = (((s·2 + q)·(N/64) + j)·128 + 32·w + 4·g + t)·4 + 2·vk + vm

    Slab s (16 K rows, all N columns) is one contiguous block of 64·N bytes,
    streamed in order; inside it, the fragment of (k8 step q, M tile j) is
    2 KB, and each thread reads its four values with one 16-byte load.
    """
    K, N = w.shape
    if K % AFRAG_K or N % 64:
        raise ValueError(f"cannot pack a ({K}, {N}) weight into tf32 A fragments")
    t = w.to(torch.float32).reshape(K // 16, 2, 2, 4, N // 64, 4, 2, 8)  # s q vk t j w vm g
    return t.permute(0, 1, 4, 5, 7, 3, 2, 6).contiguous().reshape(-1)  # [s, q, j, w, g, t, vk, vm]


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest tf32 value (ties away from zero, 10 mantissa bits),
    as K1 f32 rounds each operand (`cvt.rna.tf32.f32`): add half of the 13
    dropped bits' unit to the bit pattern, then clear them."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_k1(folded: FoldedDecoder, precision: str) -> PackedK1:
    """K1's operands for `precision`: the width padded to the next
    `K1_WIDTHS` entry, w_in with a zero 64th row, the matmul weights packed by
    `pack_afrag` (f32) or `pack_kmajor` (bf16), w_out as (H,)."""
    width = next(w for w in K1_WIDTHS if w >= folded.hidden)
    f = folded.padded(width)
    if precision == "f32":
        pack, w_out = pack_afrag, f.w_out[:, 0].contiguous()
    else:
        npass = pass_width(width)
        pack = lambda w: pack_kmajor(w, npass)
        w_out = f.w_out[:, 0].to(torch.bfloat16).contiguous()
    return PackedK1(
        folded=f,
        w_in=pack(torch.cat([f.w_in, f.w_in.new_zeros(1, width)])),
        w1=torch.cat([pack(w) for w in f.w1]),
        w2=torch.cat([pack(w) for w in f.w2]),
        w_out=w_out,
    )


@dataclass
class PackedK1:
    """K1's operands: the padded fold (its f32 vectors go to the kernel as
    they are) and the packed matmul weights."""

    folded: FoldedDecoder
    w_in: torch.Tensor  # packed (64, H)
    w1: torch.Tensor  # L packed (H, H), concatenated
    w2: torch.Tensor
    w_out: torch.Tensor  # (H,), f32 or bf16


@torch.no_grad()
def fold_decoder(decoder, latent: torch.Tensor, max_dist: float = 0.1) -> FoldedDecoder:
    """Fold a CbnDecoder (eval, running statistics) and one latent (D,)."""
    lat = latent.reshape(-1).to(torch.float32)
    a1, c1, w1, b1, a2, c2, w2, b2 = ([] for _ in range(8))
    for blk in decoder.blocks:
        A1, C1 = blk.bn_0.fold(lat)
        A2, C2 = blk.bn_1.fold(lat)
        a1.append(A1); c1.append(C1); a2.append(A2); c2.append(C2)
        w1.append(blk.fc_0.weight[:, :, 0].t()); b1.append(blk.fc_0.bias)
        w2.append(blk.fc_1.weight[:, :, 0].t()); b2.append(blk.fc_1.bias)
    AO, CO = decoder.bn.fold(lat)
    st = lambda xs: torch.stack(xs).contiguous()
    return FoldedDecoder(
        w_in=decoder.fc_p.weight.detach()[:, :, 0].t().contiguous(),
        b_in=decoder.fc_p.bias.detach().clone(),
        a1=st(a1), c1=st(c1), w1=st(w1), b1=st(b1),
        a2=st(a2), c2=st(c2), w2=st(w2), b2=st(b2),
        a_out=AO.contiguous(), c_out=CO.contiguous(),
        w_out=decoder.fc_out.weight.detach()[:, :, 0].t().contiguous(),
        b_out=decoder.fc_out.bias.detach().clone(),
        max_dist=float(max_dist),
        b_out_value=float(decoder.fc_out.bias[0]),
    )


def posenc_f32(pts: torch.Tensor, num_freqs: int = NUM_FREQS, max_freq_log2: int = 9):
    """NeRF positional encoding in f32, [x, sin(f·x), cos(f·x), ...] order.
    Frequency 2⁹ needs full f32 input precision."""
    freqs = [float(2.0 ** (max_freq_log2 * i / (num_freqs - 1))) for i in range(num_freqs)]
    parts = [pts]
    for f in freqs:
        parts.append(torch.sin(pts * f))
        parts.append(torch.cos(pts * f))
    return torch.cat(parts, dim=-1)


def folded_udf_ref(folded: FoldedDecoder, pts: torch.Tensor, dtype=torch.float32):
    """Plain PyTorch version of JAX `folded_udf`: every op in `dtype`."""
    folded_udf_ref.calls += 1
    f = folded
    cast = lambda t: t.to(dtype)
    x = posenc_f32(pts).to(dtype) @ cast(f.w_in) + cast(f.b_in)
    for i in range(f.layers):
        h = torch.relu(x * cast(f.a1[i]) + cast(f.c1[i]))
        h = h @ cast(f.w1[i]) + cast(f.b1[i])
        h = torch.relu(h * cast(f.a2[i]) + cast(f.c2[i]))
        x = x + (h @ cast(f.w2[i]) + cast(f.b2[i]))
    h = torch.relu(x * cast(f.a_out) + cast(f.c_out))
    logit = (h.float() @ f.w_out + f.b_out)[..., 0]
    return (1.0 - torch.sigmoid(logit)) * f.max_dist


folded_udf_ref.calls = 0


def _mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 inputs, f32 sums: a bf16×bf16 product is exact in f32."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def folded_udf_mixed_ref(folded: FoldedDecoder, pts: torch.Tensor):
    """Plain PyTorch version of JAX `folded_udf_mixed` (the TPU kernel's math)."""
    folded_udf_mixed_ref.calls += 1
    f = folded
    x = _mm_bf16(posenc_f32(pts), f.w_in) + f.b_in
    for i in range(f.layers):
        h = torch.relu(x * f.a1[i] + f.c1[i])
        h = _mm_bf16(h, f.w1[i]) + f.b1[i]
        h = torch.relu(h * f.a2[i] + f.c2[i])
        x = x + _mm_bf16(h, f.w2[i]) + f.b2[i]
    h = torch.relu(x * f.a_out + f.c_out)
    logit = _mm_bf16(h, f.w_out)[..., 0] + f.b_out[0]
    return (1.0 - torch.sigmoid(logit)) * f.max_dist


folded_udf_mixed_ref.calls = 0


def folded_udf_mixed_tc(folded: FoldedDecoder, pts: torch.Tensor):
    """`folded_udf_mixed_ref`'s math with each hidden matmul as one bf16
    GEMM with f32 results (`torch.mm(..., out_dtype=torch.float32)`, CUDA
    only: cuBLAS on the tensor cores). Its sums run in a tensor-core order,
    as K1 bf16's do. Every layer rounds its input to bf16, so one f32 ulp
    between two summation orders can flip a rounding; this version holds
    K1 bf16 to a far tighter bar than `folded_udf_mixed_ref` can."""
    f = folded
    mm = lambda a, w: torch.mm(a.to(torch.bfloat16), w.to(torch.bfloat16),
                               out_dtype=torch.float32)
    x = mm(posenc_f32(pts), f.w_in) + f.b_in
    for i in range(f.layers):
        h = mm(torch.relu(x * f.a1[i] + f.c1[i]), f.w1[i]) + f.b1[i]
        h = torch.relu(h * f.a2[i] + f.c2[i])
        x = x + mm(h, f.w2[i]) + f.b2[i]
    h = torch.relu(x * f.a_out + f.c_out)
    logit = _mm_bf16(h, f.w_out)[..., 0] + f.b_out[0]
    return (1.0 - torch.sigmoid(logit)) * f.max_dist

PRECISIONS = ("f32", "bf16")


def folded_udf(folded: FoldedDecoder, pts: torch.Tensor, precision: str = "f32"):
    """(P, 3) → (P,) UDF. CUDA tensors launch K1; CPU tensors take the plain
    version. Any other device, dtype or layout raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (P, 3), got {tuple(pts.shape)}")
    if pts.device.type == "cpu":
        if precision == "f32":
            return folded_udf_ref(folded, pts)
        return folded_udf_mixed_ref(folded, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    if pts.dtype != torch.float32 or not pts.is_contiguous():
        raise ValueError("pts must be a contiguous float32 tensor")
    H = folded.hidden
    if H % 32 or not 64 <= H <= 512:
        raise ValueError(f"hidden width {H} unsupported (multiple of 32 in [64, 512])")
    if folded.w_in.device != pts.device:
        raise ValueError(f"weights on {folded.w_in.device}, points on {pts.device}")
    return launch_k1(folded.packed(precision), pts, precision)


def launch_k1(pk: PackedK1, pts: torch.Tensor, precision: str) -> torch.Tensor:
    """Launch K1 on operands `pack_k1` made, on the current stream, for the
    contiguous f32 CUDA points `folded_udf` has checked."""
    if pts.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {pts.device}")
    out = torch.empty(pts.shape[0], device=pts.device, dtype=torch.float32)
    f = pk.folded
    fn = getattr(_build.load(), f"surfd_folded_mlp_{precision}")
    rc = fn(
        pts.data_ptr(), pts.shape[0], f.hidden, f.layers,
        pk.w_in.data_ptr(), f.b_in.data_ptr(),
        f.a1.data_ptr(), f.c1.data_ptr(), pk.w1.data_ptr(), f.b1.data_ptr(),
        f.a2.data_ptr(), f.c2.data_ptr(), pk.w2.data_ptr(), f.b2.data_ptr(),
        f.a_out.data_ptr(), f.c_out.data_ptr(), pk.w_out.data_ptr(),
        f.b_out_value, f.max_dist, out.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream,
    )
    _build.check(rc, "folded_mlp")
    folded_udf.launches[precision] += 1
    return out


folded_udf.launches = {"f32": 0, "bf16": 0}  # kernel launches per precision
