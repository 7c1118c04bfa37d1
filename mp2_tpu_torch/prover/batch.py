"""Batched prover: B independent witnesses of ONE circuit per call.

Port of `mp2_tpu/prover/batch.py`.  The map phase of the proof map-reduce:
leaf proofs are independent, so every stage runs with a leading batch axis
and one sequence of tensor ops serves B proofs.  Each batch element runs its
own duplex challenger lane, so the B transcripts are exactly those of B
serial proofs and every proof is individually verifiable.

PyTorch runs eagerly, so the JAX package's three jitted stages (to the
grinding point, FRI commit, query gather) are one straight function here
that keeps its challenger across them.  Every Poseidon2 permutation (Merkle
leaves and levels, transcript, PI hash, grinding) goes through K1.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mp2_tpu_torch.field import ext2
from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.field.ext2 import GF2
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.hash import poseidon2 as p2
from mp2_tpu_torch.hash.challenger import Challenger
from mp2_tpu_torch.prover import fri as fri_mod
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.algebra import TorchAlgebra
from mp2_tpu_torch.prover.fri import FriProof, FriQueryRound, FriQueryStep
from mp2_tpu_torch.prover.merkle import BatchedMerkleTree
from mp2_tpu_torch.prover.prove import (
    SHIFT,
    CircuitData,
    Openings,
    Proof,
    _lde_tables,
    _powers_device,
)


# elements of one product chunk in _weighted_sum and in the quotient's
# permutation products
_SUM_ELEMS = 1 << 24
_QUOTIENT_ELEMS = 1 << 19  # batch elements x coset points per quotient chunk

# measurement hooks, empty unless a caller measures: each is called with a
# stage's name as prove_batch leaves the stage, the quotient's parts once per
# chunk (chip_smoke.py reads the card's peak memory of each stage there)
STAGE_HOOKS: list = []


def _stage_done(name: str) -> None:
    for hook in STAGE_HOOKS:
        hook(name)


def _weighted_sum(terms: torch.Tensor, weights: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_k terms_k * weights_k along `axis` (weights broadcast against the
    terms).  The product runs in chunks of the axis holding about
    _SUM_ELEMS elements, so a field multiply's temporaries stay a fraction
    of `terms` at the wrap circuits' sizes; small tensors take one chunk.
    Field sums of canonical values are exact in any order."""
    size = terms.shape[axis]
    step = max(1, _SUM_ELEMS * size // terms.numel())
    acc = None
    for k0 in range(0, size, step):
        k = min(step, size - k0)
        part = gl.sum_axis(gl.mul(terms.narrow(axis, k0, k), weights.narrow(axis, k0, k)), axis)
        acc = part if acc is None else gl.add(acc, part)
    return acc


def _prefix_prod(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the last axis (log-depth)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        pad = torch.ones(tuple(x.shape[:-1]) + (shift,), dtype=x.dtype, device=x.device)
        x = gl.mul(x, torch.cat([pad, x[..., : n - shift]], dim=-1))
        shift *= 2
    return x


def _pairwise_prod(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Product over a power-of-two axis by halving; the axis is removed."""
    v = torch.movedim(v, axis, -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = gl.mul(v[..., :h], v[..., h : 2 * h])
    return v[..., 0]


def _compute_zs_batched(data: CircuitData, wit, betas, gammas) -> torch.Tensor:
    """Z and partial-product columns: wit (B, n, W), betas/gammas (nc, B)
    -> (B, zcols, n)."""
    cfg = data.config
    n, W = data.n, cfg.num_wires
    chunk = cfg.permutation_chunk_size
    n_chunks = -(-W // chunk)
    npp = cfg.num_partial_products
    B = wit.shape[0]
    dev = data.device
    x_pows = ntt._power_table(ntt._root_of_unity(data.log_n), n)
    kx = gl.from_u64(
        [[int(k) * int(x) % P for k in data.k_coeffs] for x in x_pows], dev
    )  # (n, W)
    sg = gl.from_u64(data.sigma_values, dev)
    cols = []
    for c in range(cfg.num_challenges):
        beta = betas[c][:, None, None]
        gamma = gammas[c][:, None, None]
        num = gl.add(gl.add(wit, gl.mul(kx[None], beta)), gamma)
        den = gl.add(gl.add(wit, gl.mul(sg[None], beta)), gamma)
        nums = _pairwise_prod(num.reshape(B, n, n_chunks, chunk), -1)
        dens = _pairwise_prod(den.reshape(B, n, n_chunks, chunk), -1)
        row_pref = _prefix_prod(gl.mul(nums, gl.inv(dens)))  # (B, n, n_chunks)
        incl = _prefix_prod(row_pref[..., n_chunks - 1])  # (B, n)
        z = torch.cat([gl.ones((B, 1), dev), incl[:, : n - 1]], dim=-1)
        pps = gl.mul(row_pref[:, :, :npp], z[:, :, None])
        cols.append(z[:, None])
        cols.append(pps.transpose(1, 2))
    return torch.cat(cols, dim=1)


def _quotient_batched(data: CircuitData, wire_lde, zs_lde, betas, gammas,
                      alphas, pi_hash) -> torch.Tensor:
    """Combined constraints / Z_H on the LDE coset: wire_lde (B, W, big),
    zs_lde (B, zc, big), challenges (nc, B), pi_hash (B, 4) -> (B, nc, big).

    Pointwise on the coset once Z(g x) is rolled into place, so the points
    run in chunks of about _QUOTIENT_ELEMS batch elements x points: the eager
    constraint evaluation holds many (B, points) temporaries at once (a
    B=16 batch of 2^16-point LDEs peaked at 66 GB in one piece).  Small
    batches take one chunk."""
    cfg = data.config
    rate = cfg.fri.rate_bits
    npp = cfg.num_partial_products
    B, _, big = wire_lde.shape
    dev = data.device
    tables = [gl.from_u64(t, dev) for t in _lde_tables(data.log_n, rate)]  # x, 1/Z_H, L0
    z_cols = [c * (1 + npp) for c in range(cfg.num_challenges)]
    z_next = torch.roll(zs_lde[:, z_cols], -(1 << rate), dims=-1)  # Z(g x), (B, nc, big)
    step = max(1, min(big, _QUOTIENT_ELEMS // B))
    parts = [
        _quotient_points(data, wire_lde[..., p:p + step], zs_lde[..., p:p + step],
                         z_next[..., p:p + step], *(t[p:p + step] for t in tables),
                         data.fixed_lde[:, p:p + step], betas, gammas, alphas, pi_hash)
        for p in range(0, big, step)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


class _AlphaSums:
    """sum_k alpha_c^k * term_k for each challenge c, over constraint terms
    that arrive in order, a group (k, B, m) at a time.  Groups wait until
    they hold about _SUM_ELEMS elements and are then weighted together: a
    large chunk keeps about one gate type's terms alive at once, a small one
    is weighted in one piece (few launches).  Field sums are exact in any
    order: the sums equal one weighted sum of all the terms stacked."""

    def __init__(self, alphas: torch.Tensor):
        self.alphas = alphas  # (nc, B)
        self.offset = [torch.ones_like(a) for a in alphas]  # alpha_c^(terms so far)
        self.sums = [None] * alphas.shape[0]
        self.pending, self.pending_elems = [], 0

    def add(self, terms: torch.Tensor) -> None:
        self.pending.append(terms)
        self.pending_elems += terms.numel()
        if self.pending_elems >= _SUM_ELEMS:
            self._weigh()

    def _weigh(self) -> None:
        terms = self.pending[0] if len(self.pending) == 1 else torch.cat(self.pending)
        self.pending, self.pending_elems = [], 0
        k = terms.shape[0]
        for c, alpha in enumerate(self.alphas):
            pows = _powers_device(alpha, k + 1)  # (k + 1, B)
            weights = gl.mul(pows[:k], self.offset[c][None])
            part = _weighted_sum(terms, weights[:, :, None], 0)
            self.sums[c] = part if self.sums[c] is None else gl.add(self.sums[c], part)
            self.offset[c] = gl.mul(self.offset[c], pows[k])

    def result(self) -> List[torch.Tensor]:
        if self.pending:
            self._weigh()
        return self.sums


def _quotient_points(data: CircuitData, wire_lde, zs_lde, z_next, x, zh_inv, l0,
                     fl, betas, gammas, alphas, pi_hash) -> torch.Tensor:
    """The quotient at m coset points: wire_lde (B, W, m), zs_lde (B, zc, m),
    z_next (B, nc, m), x / 1/Z_H / L0 (m,), fixed columns fl (F, m)
    -> (B, nc, m).  The terms are weighted as they come (_AlphaSums), and
    the permutation products run over slices of about _SUM_ELEMS elements,
    whole permutation chunks each."""
    cfg = data.config
    W = cfg.num_wires
    T = data.num_gate_types
    nC = cfg.num_constants
    npp = cfg.num_partial_products
    n_chunks = -(-W // cfg.permutation_chunk_size)
    B, _, m = wire_lde.shape
    dev = data.device

    alg = TorchAlgebra((B, m), dev)
    sel = [fl[t][None] for t in range(T)]
    consts = [fl[T + j][None] for j in range(nC)]
    sigma_m = fl[T + nC : T + nC + W]
    wires = [wire_lde[:, j] for j in range(W)]
    extras = {"pi_hash": [pi_hash[:, i][:, None] for i in range(4)]}
    sums = _AlphaSums(alphas)
    for t, (_, gate) in enumerate(data.gate_types):
        terms = [alg.mul(sel[t], c) for c in gate.constraints(alg, wires, consts, extras)]
        if terms:
            sums.add(torch.stack(terms))
        del terms
    _stage_done("quotient_gates")

    k_vec = gl.from_u64(data.k_coeffs, dev)
    width = W // n_chunks  # wires per permutation chunk
    step = max(1, _SUM_ELEMS // (B * width * m))  # permutation chunks per slice
    for c in range(cfg.num_challenges):
        beta = betas[c][:, None, None]
        gamma = gammas[c][:, None, None]
        base = c * (1 + npp)
        z = zs_lde[:, base]
        partials = zs_lde[:, base + 1 : base + 1 + npp]
        sums.add(gl.mul(l0, gl.sub(z, torch.ones_like(z)))[None])
        bk = gl.mul(k_vec[None, :, None], beta)  # (B, W, 1)
        nums, dens = [], []
        for g0 in range(0, n_chunks, step):
            g = min(step, n_chunks - g0)
            w = slice(g0 * width, (g0 + g) * width)
            num = gl.add(gl.add(wire_lde[:, w], gl.mul(bk[:, w], x)), gamma)
            nums.append(_pairwise_prod(num.reshape(B, g, width, m), 2))
            del num
            den = gl.add(gl.add(wire_lde[:, w], gl.mul(sigma_m[w][None], beta)), gamma)
            dens.append(_pairwise_prod(den.reshape(B, g, width, m), 2))
            del den
        nums, dens = torch.cat(nums, dim=1), torch.cat(dens, dim=1)  # (B, n_chunks, m)
        pps = torch.cat([z[:, None], partials, z_next[:, c][:, None]], dim=1)
        diff = gl.sub(gl.mul(pps[:, 1:], dens), gl.mul(pps[:, :-1], nums))
        del nums, dens, pps
        sums.add(diff.transpose(0, 1))  # (n_chunks, B, m)
        del diff
    _stage_done("quotient_permutation")
    out = torch.stack([gl.mul(acc, zh_inv) for acc in sums.result()], dim=1)
    _stage_done("quotient_sums")
    return out


def _ext_powers_batched(z: GF2, count: int) -> GF2:
    """(count, B) extension powers [1, z, z^2, ...] per batch element."""
    pows = ext2.ones((1,) + tuple(z.c0.shape), z.c0.device)
    step = GF2(z.c0[None], z.c1[None])
    while pows.c0.shape[0] < count:
        pows = ext2.cat([pows, ext2.mul(pows, step)], 0)
        step = ext2.mul(step, step)
    return pows[:count]


def _eval_at_ext_batched(coeffs: torch.Tensor, zpows: GF2) -> GF2:
    """coeffs (B, C, n) at per-element points via zpows (n, B) -> (B, C)."""
    c0 = gl.sum_axis(gl.mul(coeffs, zpows.c0.T[:, None, :]), axis=-1)
    c1 = gl.sum_axis(gl.mul(coeffs, zpows.c1.T[:, None, :]), axis=-1)
    return GF2(c0, c1)


def _combine_invs(zeta: GF2, gzeta: GF2, big: int, device):
    """(x - zeta)^-1 and (x - g zeta)^-1 over the LDE coset, (B, big)."""
    B = zeta.c0.shape[0]
    log_big = big.bit_length() - 1
    x = gl.mul_const(
        gl.from_u64(ntt._power_table(ntt._root_of_unity(log_big), big), device),
        SHIFT,
    )
    xe = GF2(x[None].expand(B, big), gl.zeros((B, big), device))

    def inv_at(z: GF2):
        return ext2.inv(ext2.sub(xe, GF2(z.c0[:, None], z.c1[:, None])))

    return inv_at(zeta), inv_at(gzeta)


def _combine_core(ldes, z_lde, opens1: GF2, opens2: GF2, alpha: GF2,
                  inv1: GF2, inv2: GF2) -> GF2:
    """FINAL(x) = sum_i a^i (p_i(x) - o_i)/(x - zeta)
               + a^C1 * sum_i a^i (z_i(x) - o'_i)/(x - g zeta), per element.
    The p_i are the columns of `ldes` in order, a list of (B, C_j, big)
    oracles summed one at a time (no copy of them all side by side)."""
    C1 = sum(lde.shape[1] for lde in ldes)
    C2 = z_lde.shape[1]
    apows = _ext_powers_batched(alpha, max(C1, C2) + 1)  # (k, B)

    def batch_sum(parts, opens: GF2, k: int):
        ap = GF2(apows.c0[:k].T, apows.c1[:k].T)  # (B, k)
        acc0 = acc1 = None
        first = 0
        for lde in parts:
            w = lde.shape[1]
            p0 = _weighted_sum(lde, ap.c0[:, first:first + w, None], 1)
            p1 = _weighted_sum(lde, ap.c1[:, first:first + w, None], 1)
            acc0 = p0 if acc0 is None else gl.add(acc0, p0)
            acc1 = p1 if acc1 is None else gl.add(acc1, p1)
            first += w
        o = ext2.sum_axis(ext2.mul(ap, opens), axis=1)  # (B,)
        return ext2.sub(GF2(acc0, acc1), GF2(o.c0[:, None], o.c1[:, None]))

    q1 = ext2.mul(batch_sum(ldes, opens1, C1), inv1)
    q2 = ext2.mul(batch_sum([z_lde], opens2, C2), inv2)
    shift = apows[C1]  # (B,)
    q2s = ext2.mul(q2, GF2(shift.c0[:, None], shift.c1[:, None]))
    return ext2.add(q1, q2s)


def _grind_from_state(state: torch.Tensor, buffer: torch.Tensor,
                      pow_bits: int) -> np.ndarray:
    """Per-element grinding from a challenger snapshot: state (12, B),
    pending inputs (k, B).  Returns, for each element, the FIRST nonce whose
    challenge has pow_bits leading zeros; all elements and a whole span of
    nonces are searched in one permutation call."""
    B = state.shape[1]
    if pow_bits == 0:
        return np.zeros(B, dtype=np.uint64)
    span = max(2048, 1 << (pow_bits + 3))
    dev = state.device
    offsets = torch.arange(span, dtype=torch.int64, device=dev)
    found = np.zeros(B, dtype=bool)
    out = np.zeros(B, dtype=np.uint64)
    base = 0
    while not found.all():
        clone = Challenger((B, span), dev)
        clone.state = state[:, :, None].expand(-1, B, span)
        clone.input_buffer = [b[:, None].expand(B, span) for b in buffer]
        clone.observe((base + offsets)[None].expand(B, span))
        c = clone.get_challenge()  # (B, span)
        ok = ((c >> (64 - pow_bits)) & ((1 << pow_bits) - 1)) == 0
        first = torch.where(ok, offsets, span).min(dim=1).values.cpu().numpy()
        for b in range(B):
            if not found[b] and first[b] < span:
                out[b] = base + int(first[b])
                found[b] = True
        base += span
    return out


def _gather(tree, idx):
    """Opened rows and Merkle siblings of a tree (a BatchedMerkleTree, or a
    MerkleTree shared by the batch) at idx (B, q) -> (B, q, w),
    (B, q, depth, 4)."""
    B, q = idx.shape
    lf = tree.rows(idx)
    levels = [l.expand(B, -1, -1) if l.dim() == 2 else l
              for l in tree.digest_levels[:-1]]
    sibs = []
    i = idx
    for lvl in levels:
        sibs.append(torch.gather(lvl, 1, (i ^ 1)[..., None].expand(B, q, 4)))
        i = i >> 1
    if not sibs:
        return lf, gl.zeros((B, q, 0, 4), idx.device)
    return lf, torch.stack(sibs, dim=2)


def prove_batch(
    data: CircuitData,
    witnesses: np.ndarray,  # (B, n, W) uint64
    public_inputs: Sequence[Sequence[int]],
) -> List[Proof]:
    """B proofs of one circuit, on `data.device`; bit-identical to B serial
    proofs of the reference prover."""
    cfg = data.config
    dev = data.device
    n, log_n = data.n, data.log_n
    W = cfg.num_wires
    nc = cfg.num_challenges
    qk = cfg.quotient_degree_factor
    npp = cfg.num_partial_products
    rate = cfg.fri.rate_bits
    big = n << rate
    cap_h = min(cfg.fri.cap_height, log_n)
    final_len = 1 << cfg.fri_final_poly_bits
    B = witnesses.shape[0]
    if len(public_inputs) != B:
        raise ValueError(f"{B} witnesses but {len(public_inputs)} public-input lists")

    n_pi = len(data.public_inputs)
    if any(len(p) != n_pi for p in public_inputs):
        raise ValueError(f"the circuit has {n_pi} public inputs; got lists of "
                         f"lengths {sorted({len(p) for p in public_inputs})}")
    pi_h = p2.hash_no_pad(gl.from_u64(
        np.array([[int(x) % P for x in p] for p in public_inputs], dtype=np.uint64)
        .reshape(B, n_pi), dev))  # (B, 4)

    ch = Challenger((B,), dev)
    ch.observe(gl.from_u64(data.circuit_digest, dev).expand(B, 4))
    ch.observe(pi_h)
    _stage_done("pi_hash")

    # --- wires ---
    wit = gl.from_u64(np.asarray(witnesses, dtype=np.uint64), dev)  # (B, n, W)
    wire_coeffs = ntt.intt(wit.transpose(1, 2).contiguous())  # (B, W, n)
    wire_lde = ntt.lde(wire_coeffs, rate, SHIFT)
    wires_tree = BatchedMerkleTree.from_lde(wire_lde, cap_height=cap_h)
    ch.observe(wires_tree.cap.reshape(B, -1))
    betas = torch.stack(ch.get_n_challenges(nc))  # (nc, B)
    gammas = torch.stack(ch.get_n_challenges(nc))
    _stage_done("wires")

    # --- permutation columns ---
    zs_coeffs = ntt.intt(_compute_zs_batched(data, wit, betas, gammas))
    zs_lde = ntt.lde(zs_coeffs, rate, SHIFT)
    zs_tree = BatchedMerkleTree.from_lde(zs_lde, cap_height=cap_h)
    ch.observe(zs_tree.cap.reshape(B, -1))
    alphas = torch.stack(ch.get_n_challenges(nc))
    _stage_done("zs")

    # --- quotient ---
    quo_vals = _quotient_batched(data, wire_lde, zs_lde, betas, gammas, alphas, pi_h)
    quo_coeffs = ntt.coset_intt(quo_vals, SHIFT).reshape(B, nc * qk, n)
    quo_lde = ntt.lde(quo_coeffs, rate, SHIFT)
    quo_tree = BatchedMerkleTree.from_lde(quo_lde, cap_height=cap_h)
    ch.observe(quo_tree.cap.reshape(B, -1))
    zeta = ch.get_extension_challenge()
    _stage_done("quotient")

    # --- openings at zeta (all oracles) and g*zeta (Z columns) ---
    g = ntt._root_of_unity(log_n)
    gzeta = ext2.mul_const(zeta, g)
    zpows = _ext_powers_batched(zeta, n)  # (n, B)
    gzpows = _ext_powers_batched(gzeta, n)
    F = data.fixed_lde.shape[0]
    z_cols = torch.tensor([c * (1 + npp) for c in range(nc)], device=dev)
    opens = ext2.cat([
        _eval_at_ext_batched(data.fixed_coeffs[None].expand(B, -1, -1), zpows),
        _eval_at_ext_batched(wire_coeffs, zpows),
        _eval_at_ext_batched(zs_coeffs, zpows),
        _eval_at_ext_batched(quo_coeffs, zpows),
        _eval_at_ext_batched(zs_coeffs[:, z_cols], gzpows),
    ], 1)  # (B, n_open)
    ch.observe(torch.stack([opens.c0, opens.c1], dim=2).reshape(B, -1))
    alpha_fri = ch.get_extension_challenge()
    _stage_done("openings")

    # --- FRI: combined polynomial, commit phase, grinding, queries ---
    inv1, inv2 = _combine_invs(zeta, gzeta, big, dev)
    ldes = [data.fixed_lde[None].expand(B, -1, -1), wire_lde, zs_lde, quo_lde]
    n1 = sum(lde.shape[1] for lde in ldes)
    if B * n1 * big <= _SUM_ELEMS:  # small oracles: one product, fewer launches
        ldes = [torch.cat(ldes, dim=1)]
    final_evals = _combine_core(
        ldes, zs_lde[:, z_cols], opens[:, :n1], opens[:, n1:], alpha_fri,
        inv1, inv2,
    )
    _stage_done("combine")
    fold_trees, fc0, fc1 = fri_mod.commit_phase(
        ch, fri_mod.bit_reverse_ext(final_evals), cfg.fri, log_n,
        cfg.fri_final_poly_bits, SHIFT,
    )
    _stage_done("fri_commit")
    buffer = (torch.stack(ch.input_buffer) if ch.input_buffer
              else gl.zeros((0, B), dev))
    pow_witnesses = _grind_from_state(ch.state, buffer, cfg.fri.proof_of_work_bits)
    ch.observe(gl.from_u64(pow_witnesses, dev))
    ch.get_challenge()  # pow response, keeps transcripts in lockstep
    _stage_done("grinding")
    idx = torch.stack(
        ch.get_n_challenges(cfg.fri.num_query_rounds), dim=1
    ) & (big - 1)  # (B, q); big is a power of two

    oracles = {"fixed": data.fixed_tree, "wires": wires_tree, "zs": zs_tree,
               "quo": quo_tree}
    q_out = {k: _gather(tree, idx) for k, tree in oracles.items()}
    folds = []
    i = idx
    for t in fold_trees:
        i = i >> 1
        folds.append(_gather(t, i))

    # ---- one transfer of everything the serialized proofs need ----
    host = gl.to_u64
    if np.any(host(fc0[:, final_len:])) or np.any(host(fc1[:, final_len:])):
        raise RuntimeError("combined polynomial exceeds claimed degree")
    caps = {k: host(t.cap) for k, t in
            (("wires", wires_tree), ("zs", zs_tree), ("quo", quo_tree))}
    fold_caps = [host(t.cap) for t in fold_trees]
    qh = {k: (host(a), host(b)) for k, (a, b) in q_out.items()}
    fold_h = [(host(a).tolist(), host(b)) for a, b in folds]
    fc0_l = host(fc0[:, :final_len]).tolist()
    fc1_l = host(fc1[:, :final_len]).tolist()
    o0_l = host(opens.c0).tolist()
    o1_l = host(opens.c1).tolist()
    zc = nc * (1 + npp)
    qc = nc * qk
    _stage_done("queries")

    proofs: List[Proof] = []
    for b in range(B):
        query_rounds = []
        for q in range(cfg.fri.num_query_rounds):
            steps = []
            for pairs, sibs in fold_h:
                row = pairs[b][q]
                steps.append(FriQueryStep(
                    pair=((row[0], row[1]), (row[2], row[3])),
                    siblings=sibs[b, q],
                ))
            query_rounds.append(FriQueryRound(
                initial_leaves=[qh[k][0][b, q] for k in oracles],
                initial_siblings=[qh[k][1][b, q] for k in oracles],
                steps=steps,
            ))
        o0, o1 = o0_l[b], o1_l[b]

        def seg(lo, hi):
            return list(zip(o0[lo:hi], o1[lo:hi]))

        proofs.append(Proof(
            wires_cap=caps["wires"][b],
            zs_cap=caps["zs"][b],
            quotient_cap=caps["quo"][b],
            openings=Openings(
                fixed=seg(0, F),
                wires=seg(F, F + W),
                zs_partials=seg(F + W, F + W + zc),
                quotient=seg(F + W + zc, F + W + zc + qc),
                zs_next=seg(F + W + zc + qc, F + W + zc + qc + nc),
            ),
            fri=FriProof(
                commit_caps=[c[b] for c in fold_caps],
                final_poly=list(zip(fc0_l[b], fc1_l[b])),
                pow_witness=int(pow_witnesses[b]),
                query_rounds=query_rounds,
            ),
            public_inputs=[int(x) for x in public_inputs[b]],
        ))
    return proofs


def permutation_count(data: CircuitData) -> int:
    """Analytic count of Poseidon2 permutations per proof in `prove_batch`
    (Merkle commitments + FRI fold trees + the duplex challenger lane;
    grinding not included)."""
    cfg = data.config
    n, log_n = data.n, data.log_n
    rate = cfg.fri.rate_bits
    big = n << rate
    cap_h = min(cfg.fri.cap_height, log_n)
    W = cfg.num_wires
    nc = cfg.num_challenges
    zc = nc * (1 + cfg.num_partial_products)
    qc = nc * cfg.quotient_degree_factor

    def tree(m: int, width: int, ch: int) -> int:
        leaf = 0 if width <= 4 else -(-width // 8) * m  # hash_or_noop
        return leaf + (m - (1 << ch))  # internal two_to_one nodes

    total = tree(big, W, cap_h) + tree(big, zc, cap_h) + tree(big, qc, cap_h)
    # FRI fold trees: pairs-of-ext leaves are width 4 (noop)
    cur_log = log_n + rate
    for _ in range(log_n - cfg.fri_final_poly_bits):
        ch = min(cfg.fri.cap_height, cur_log - 1)
        total += tree(1 << (cur_log - 1), 4, ch)
        cur_log -= 1
    # challenger duplex: one permutation per 8 absorbed elements plus one
    # per squeeze refill (approximate; small vs the trees)
    n_open = data.fixed_lde.shape[0] + W + zc + qc + nc
    absorbed = (
        8  # circuit digest + pi hash
        + 3 * (1 << cap_h) * 4  # commitment caps
        + 2 * n_open  # openings (ext pairs)
        + (log_n - cfg.fri_final_poly_bits) * (1 << cfg.fri.cap_height) * 4
        + 2 * (1 << cfg.fri_final_poly_bits)  # final poly
        + 2  # pow
    )
    squeezes = 3 * nc + 4 + cfg.fri.num_query_rounds + 8
    total += -(-absorbed // 8) + squeezes
    return total
