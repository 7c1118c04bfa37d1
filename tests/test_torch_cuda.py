"""K1, K2 (and its entries), K2c, P1, the batched prover, the fixed-data
cache, the pipeline's tabular query and the merged table's indexer on a CUDA
card.  These tests skip where there is no card.  The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

from mp2_tpu_torch.field import goldilocks as gl
from mp2_tpu_torch.hash import poseidon2_host as p2h
from mp2_tpu_torch.ops import ntt_cuda as N
from mp2_tpu_torch.ops import ntt_t_cuda as T
from mp2_tpu_torch.ops import poseidon2_cuda as K
from mp2_tpu_torch.ops import probe_cuda as PC
from mp2_tpu_torch.prover import ntt
from mp2_tpu_torch.prover.batch import prove_batch
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify
from mp2_tpu_torch.recursion.tp2_backend import _build_tree_node, tree_node_batch

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "mp2_tpu_torch", "testdata", "tree_node_golden.json",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_and_host(cuda):
    """K1 against its plain version, bit for bit, edge lanes included."""
    rng = np.random.default_rng(3)
    st = rng.integers(0, gl.P, size=(12, 4099), dtype=np.uint64)
    st[:, :4] = np.array([0, gl.P - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)
    x = gl.from_u64(st, cuda)
    before = K.permute_planar.launches
    got = K.permute_planar(x)
    assert K.permute_planar.launches == before + 1
    assert torch.equal(got, K.permute_planar_plain(x))
    out = gl.to_u64(got)
    for i in range(8):
        assert [int(v) for v in out[:, i]] == p2h.permute([int(v) for v in st[:, i]])
    with pytest.raises(ValueError):
        K.permute_planar(x[:, ::2])  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", list(range(1, 15)))
def test_ntt_kernel_matches_plain(cuda, log_n):
    """K2 against its plain version, bit for bit, with every flag."""
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    x = gl.from_u64(rng.integers(0, gl.P, size=(8, n), dtype=np.uint64), cuda)
    tw = gl.from_u64(rng.integers(0, gl.P, size=(2, n), dtype=np.uint64), cuda)
    for inverse in (False, True):
        for kw in ({}, {"scale": True}, {"bitrev_input": True},
                   {"twiddle": tw, "scale": True, "bitrev_input": True}):
            before = N.ntt_rows.launches
            got = N.ntt_rows(x, inverse, **kw)
            assert N.ntt_rows.launches == before + 1
            assert torch.equal(got, N.ntt_rows_plain(x, inverse, **kw))
    with pytest.raises(ValueError):
        N.ntt_rows(x[:, ::2], False)  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", list(range(1, 15)))
def test_ntt_entries_match_plain(cuda, log_n):
    """K2's LDE (rates 1 and 3) and coset-iNTT entries against their plain
    twins, bit for bit, one launch each; a coset iNTT undoes an LDE."""
    rng = np.random.default_rng(100 + log_n)
    x = gl.from_u64(rng.integers(0, gl.P, size=(7, 1 << log_n), dtype=np.uint64), cuda)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    before = N.ntt_rows.launches
    assert torch.equal(N.coset_intt_rows(x, shift), N.coset_intt_rows_plain(x, shift))
    assert N.ntt_rows.launches == before + 1
    for rate in (1, 3) if log_n >= 3 else (1,):
        c = x[:, : 1 << (log_n - rate)].contiguous()
        evals = N.lde_rows(c, rate, shift)
        assert torch.equal(evals, N.lde_rows_plain(c, rate, shift))
        assert torch.equal(N.coset_intt_rows(evals, shift)[:, : c.shape[1]], c)


@pytest.mark.cuda
def test_four_step_on_card_matches_cpu(cuda):
    """The four-step NTT at 2^15 (two K2c launches) equals the CPU's."""
    x = np.random.default_rng(15).integers(0, gl.P, size=(2, 1 << 15), dtype=np.uint64)
    for inverse in (False, True):
        before = T.ntt_four_step_t.launches
        got = ntt.ntt(gl.from_u64(x, cuda), inverse)
        assert T.ntt_four_step_t.launches == before + 2
        assert torch.equal(got.cpu(), ntt.ntt(gl.from_u64(x, "cpu"), inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [13, 15])
def test_prover_ntt_takes_strided_input_on_card(cuda, log_n):
    """2-D strided views (a column slice of wider rows, every other row)
    through prover/ntt's ntt, intt, lde and coset_intt on K2 (2^13) and K2c
    (2^15), equal to their contiguous copies: `reshape` alone keeps such a
    view strided, and the kernels refuse it."""
    rng = np.random.default_rng(200 + log_n)
    n = 1 << log_n
    wide = gl.from_u64(rng.integers(0, gl.P, size=(6, 2 * n), dtype=np.uint64), cuda)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    for x in (wide[:, :n], wide[::2, n:]):
        assert not x.is_contiguous()
        xc = x.contiguous()
        c = x[:, : n >> 3]
        assert torch.equal(ntt.ntt(x), ntt.ntt(xc))
        assert torch.equal(ntt.intt(x), ntt.intt(xc))
        assert torch.equal(ntt.lde(c, 3, shift), ntt.lde(c.contiguous(), 3, shift))
        assert torch.equal(ntt.coset_intt(x, shift), ntt.coset_intt(xc, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [6, 9, 16, 18])
def test_four_step_kernel_matches_plain(cuda, log_n):
    """K2c against its plain version, bit for bit, both directions."""
    x = gl.from_u64(np.random.default_rng(log_n).integers(
        0, gl.P, size=(3, 1 << log_n), dtype=np.uint64), cuda)
    for inverse in (False, True):
        assert torch.equal(T.ntt_four_step_t(x, inverse), T.ntt_four_step_plain(x, inverse))
    with pytest.raises(ValueError):
        T.ntt_four_step_t(x[:, ::2], False)  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [5, 31])
def test_four_step_kernel_refuses_sizes_it_does_not_take(cuda, log_n):
    # a broadcast view: the size is refused before the kernel reads a word
    x = torch.zeros((1, 1), dtype=torch.int64, device=cuda).expand(1, 1 << log_n)
    with pytest.raises(ValueError, match="takes rows of"):
        T.ntt_four_step_t(x, False)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [21, 22])
def test_four_step_kernel_above_2_20_matches_plain(cuda, log_n):
    """K2c's three passes against the plain twin, bit for bit: the
    transform both ways, the LDE (rate 3) and the coset iNTT, through
    prover/ntt."""
    rng = np.random.default_rng(log_n)
    x = gl.from_u64(rng.integers(0, gl.P, size=(2, 1 << log_n), dtype=np.uint64), cuda)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    for inverse in (False, True):
        before = T.ntt_four_step_t.launches
        assert torch.equal(ntt.ntt(x, inverse), T.ntt_four_step_plain(x, inverse))
        assert T.ntt_four_step_t.launches == before + 3
    c = x[:, : 1 << (log_n - 3)].contiguous()
    assert torch.equal(ntt.lde(c, 3, shift), T.lde_t_plain(c, 3, shift))
    assert torch.equal(ntt.coset_intt(x, shift), T.coset_intt_t_plain(x, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("batch, cols, log_m, cap", [(2, 136, 10, 4), (1, 3, 6, 0),
                                                      (3, 12, 12, 2), (1, 9, 20, 0)])
def test_merkle_entries_match_plain(cuda, batch, cols, log_m, cap):
    """K1's leaf-hash and level entries against their plain twins, bit for
    bit; the levels of 2^20 leaves take three launches."""
    rng = np.random.default_rng(log_m)
    lde = gl.from_u64(rng.integers(0, gl.P, size=(batch, cols, 1 << log_m),
                                   dtype=np.uint64), cuda)
    before = K.launches()
    digests = K.hash_leaves(lde)
    levels = K.merkle_levels(digests, cap)
    assert K.launches() == before + 1 + -(-(log_m - cap) // K.LEVELS_PER_LAUNCH)
    if log_m <= 12:
        assert torch.equal(digests, K.hash_leaves_plain(lde))
    want = K.merkle_levels_plain(digests, cap)
    assert all(torch.equal(a, b) for a, b in zip(levels, want, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("log_big, rate", [(6, 1), (15, 3), (16, 3), (19, 3), (20, 1)])
def test_lde_and_coset_intt_kernels_match_plain(cuda, log_big, rate):
    """K2c's LDE and coset-iNTT entries against their plain twins."""
    rng = np.random.default_rng(log_big)
    coeffs = gl.from_u64(rng.integers(0, gl.P, size=(3, 1 << (log_big - rate)),
                                      dtype=np.uint64), cuda)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    before = T.ntt_four_step_t.launches
    evals = T.lde_t(coeffs, rate, shift)
    assert T.ntt_four_step_t.launches == before + 2
    assert torch.equal(evals, T.lde_t_plain(coeffs, rate, shift))
    back = T.coset_intt_t(evals, shift)
    assert torch.equal(back, T.coset_intt_t_plain(evals, shift))
    assert torch.equal(back[:, :coeffs.shape[1]], coeffs) and not back[:, coeffs.shape[1]:].any()


@pytest.mark.cuda
def test_probe_kernel_matches_plain(cuda):
    """P1: every op and chain length against its plain twin."""
    a, b = PC.inputs(cuda, 1 << 12)
    for op in PC.OPS:
        for k in PC.ks(op):
            assert torch.equal(PC.probe(op, k, a, b), PC.probe_plain(op, k, a, b)), (op, k)


@pytest.mark.cuda
def test_prove_batch_on_card_matches_golden(cuda):
    """B=2 tree-node proofs made on the card equal the JAX package's."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    data, inputs = _build_tree_node(test_config(), cuda)
    wits, pis = tree_node_batch(data, inputs, golden["batch"], golden["seed"])
    before = (K.permute_planar.launches, K.hash_leaves.launches, K.merkle_levels.launches)
    proofs = prove_batch(data, wits, pis)
    after = (K.permute_planar.launches, K.hash_leaves.launches, K.merkle_levels.launches)
    assert all(a > b for a, b in zip(after, before))
    assert [proof_sha256(proof_to_dict(p)) for p in proofs] == golden["proof_sha256"]
    assert all(verify(data, p) for p in proofs)


@pytest.mark.cuda
def test_fixed_cache_warm_compile_on_card(cuda, tmp_path, monkeypatch):
    """With MP2_FIXED_CACHE set, a second compile of a circuit reads the
    fixed data the first wrote: the same digest and proofs, its tensors on
    the card, and no Merkle hashing of its own."""
    monkeypatch.setenv("MP2_FIXED_CACHE", str(tmp_path))
    cold, inputs = _build_tree_node(test_config(), cuda)
    assert len(os.listdir(tmp_path)) == 1
    before = (K.hash_leaves.launches, K.merkle_levels.launches)
    warm, warm_inputs = _build_tree_node(test_config(), cuda)
    assert (K.hash_leaves.launches, K.merkle_levels.launches) == before
    assert warm.circuit_digest == cold.circuit_digest
    for t in (warm.fixed_coeffs, warm.fixed_lde, *warm.fixed_tree.digest_levels):
        assert t.device.type == "cuda"
    for a, b in zip(warm.fixed_tree.digest_levels, cold.fixed_tree.digest_levels, strict=True):
        assert torch.equal(a, b)
    shas = [[proof_sha256(proof_to_dict(p)) for p in prove_batch(d, *tree_node_batch(d, i, 2, 0))]
            for d, i in ((cold, inputs), (warm, warm_inputs))]
    assert shas[0] == shas[1]


@pytest.mark.cuda
def test_keccak_circuit_proved_on_card(cuda, monkeypatch):
    """The single-block keccak256_fixed circuit of
    tests/test_keccak_gadget.py:24 compiled and proved on the card and
    accepted by the port's verifier; its witness equals the CPU build's and
    its public inputs are the host keccak-256 of the message."""
    from mp2_tpu_torch.circuit.builder import CircuitBuilder
    from mp2_tpu_torch.circuit.gadgets.keccak import bits_to_u32s, keccak256_fixed, set_bytes
    from mp2_tpu_torch.prover import prove as prove_mod
    from mp2_tpu_torch.utils.keccak import keccak256

    msg = bytes(range(64))

    def build(device):
        b = CircuitBuilder(test_config())
        byte_ts = b.add_inputs(len(msg))
        b.register_public_inputs(bits_to_u32s(b, keccak256_fixed(b, byte_ts)))
        data = b.build(device)
        inputs = {}
        set_bytes(inputs, byte_ts, msg)
        return data, data.generate_witness(inputs)

    data, w = build(cuda)
    assert data.fixed_lde.device.type == "cuda"
    bits = [(byte >> k) & 1 for byte in keccak256(msg) for k in range(8)]
    pis = [sum(bit << k for k, bit in enumerate(bits[i:i + 32])) for i in range(0, 256, 32)]
    proof = prove_mod.prove(data, w, pis)
    assert verify(data, proof)
    monkeypatch.setattr(prove_mod.CircuitData, "_build_fixed", lambda self: None)
    cpu_data, cpu_w = build("cpu")
    assert cpu_data.n == data.n
    np.testing.assert_array_equal(cpu_w, w)


@pytest.mark.cuda
def test_pipeline_tabular_query_on_card(cuda):
    """tests/test_circuit_pipeline.py's tabular query (SELECT DISTINCT value
    ... value >= 150 LIMIT 2 over blocks [100, 101]) through
    CircuitTableIndexer.run_query after block 101, with chip_smoke.py's
    phases and checks: the indexer's sets (the query sets among them)
    against the golden records, block 101 through apply_block, then two
    tree-bound `row` proofs and `revelation_tabular`, verified, every
    member's PIs, the revealed values and the result [150, 200] equal to
    the JAX package's; each kernel shape the query feeds that block 101 did
    not, bit for bit against its plain twin.  chip_smoke.py proves the
    other two queries; this one runs here to keep the script inside its
    time limit.  About a quarter of an hour: the set-up and block 101 come
    first."""
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as S

    golden = {}
    for name in ("extraction", "final_extraction", "vdb", "pipeline"):
        with open(os.path.join(repo, S.TESTDATA, f"{name}_golden.json")) as f:
            golden[name] = json.load(f)
    x, fin, v, p = (golden[k] for k in ("extraction", "final_extraction", "vdb", "pipeline"))
    card = torch.cuda.get_device_name(0)
    cfg, chain = S._pipeline_chain()
    ix = S.phase_pipeline_setup(card, cuda, cfg, chain[-1], x, fin, v, p)
    launches, shapes = {}, S._ShapeLog()
    S.phase_pipeline_block(card, ix, cfg, chain[-1], x, fin, p, launches, shapes)
    seen = set(shapes.keys)
    (tabular,) = [q for q in S.PIPELINE_QUERIES if q not in S.SCRIPT_QUERIES]
    S.phase_pipeline_queries(card, ix, p, launches, shapes, [tabular])
    rng = np.random.default_rng(5)
    for key in sorted(shapes.keys - seen, key=repr):
        _, _, _, err = S.check_shape(card, key, rng, cuda)
        assert err == 0


@pytest.mark.cuda
def test_merged_table_pipeline_on_card(cuda):
    """tests/test_merged_table.py:122-168 in the port, on chip_smoke.py's
    contract: MergedTableIndexer (default branch arities, the four-column
    query sets) applies blocks 100 and 101, each block's extraction joined
    by final_merge (accepted by ix.fx), its rows tree carrying the supply
    cell, block_leaf_bound then block_parent_bound with is_merge = 1,
    ivc_first then ivc_subsequent (the last accepted); then SUM(value),
    MAX(supply) over [100, 101] is proved and reveals 720 and 370.  Every
    set is held against the JAX package's record; every member proof's PIs
    (the walks' roots, the account leaf's, the header's, final_merge's, the
    cells, rows, block and IVC members', the query's) against
    merged_golden.json, and the result and revealed values too.  Prints
    each step's wall and the card's name and power limit.  About half an
    hour: the sets take most of it."""
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as S
    from mp2_tpu_torch.models.circuit_pipeline import MergedTableIndexer

    golden = {}
    for name in ("extraction", "final_extraction", "vdb", "merged"):
        with open(os.path.join(repo, S.TESTDATA, f"{name}_golden.json")) as f:
            golden[name] = json.load(f)
    x, fin, v, mg = (golden[k] for k in ("extraction", "final_extraction", "vdb", "merged"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() or \
        torch.cuda.get_device_name(0)
    gs = S.merged_sets_golden(mg, (1, 2, 3))
    cfg, chain = S._merged_chain()
    ix = MergedTableIndexer(cfg, config=test_config(), device=cuda)
    walls = {}
    t0 = time.perf_counter()
    with S._timed_sets(walls):
        ix._ensure_built(chain[0].header_rlp)
    setup = time.perf_counter() - t0
    values, vdb = walls["ValuesExtractionCircuits"], walls["VerifiableDbCircuits"][0]
    S._check_set("merged values (mapping)", ix.vx.fw, x["set"], values[0])
    for name, fw, wall in (("vx_b", ix.vx_b.fw, values[1]),
                           ("fx", ix.fx.fw, walls["FinalExtractionCircuits"][0]),
                           ("block", ix.vdb.block, vdb), ("ivc", ix.vdb.ivc, vdb)):
        S._check_set(f"merged {name}", fw, gs[name], wall)
    for name, fw, cls in (("contract", ix.cx.fw, "ContractExtractionCircuits"),
                          ("block", ix.bx.fw, "BlockExtractionFramework")):
        S._check_set(f"merged extraction {name}", fw, fin["sets"][name], walls[cls][0])
    S._vdb_sets("merged vdb", ix.vdb, v["light"], ("cells", "rows"))
    qp = mg["query"]["params"]
    assert [ix.row_tree_depth, ix.index_tree_depth, ix.tabular_rows] == [
        qp["row_tree_depth"], qp["index_tree_depth"], qp["tabular_rows"]]
    for name in S.QUERY_SETS:
        S._check_set(f"merged query {name}", getattr(ix.qc, name), mg["query"][name],
                     walls["QueryCircuits"][0])
    S._settled()  # as the script's processes: the set-up's objects frozen, no collector
    try:
        _merged_blocks_and_query(S, ix, chain, mg, card, setup, walls)
    finally:
        gc.enable()
        gc.unfreeze()


def _merged_blocks_and_query(S, ix, chain, mg, card, setup, walls):
    """test_merged_table_pipeline_on_card's proofs and checks, after its
    set-up."""
    import time

    fws = {"vx": ix.vx.fw, "vx_b": ix.vx_b.fw, "cx": ix.cx.fw, "bx": ix.bx.fw,
           "fx": ix.fx.fw, **{n: getattr(ix.vdb, n) for n in S.VDB_SETS},
           **{n: getattr(ix.qc, n) for n in S.QUERY_SETS}}
    members, envs, steps = [], [], []
    with S._member_log(fws, members, envs):
        for blk in chain:
            first, t0 = len(members), time.perf_counter()
            final_env = ix.apply_block(blk)
            torch.cuda.synchronize()
            steps.append((f"block {blk.number}", first, time.perf_counter() - t0))
            assert final_env.member == "final_merge" and ix.fx.verify(final_env)
        assert ix.vdb.ivc.verify(ix.ivc_env) and ix.ivc_env.member == "ivc_subsequent"
        sql, values = S.MERGED_QUERY
        first, t0 = len(members), time.perf_counter()
        res, env, reveal = ix.run_query(sql, S.Placeholders(dict(values)))
        torch.cuda.synchronize()
        steps.append(("query", first, time.perf_counter() - t0))
    assert ix.verify(env)
    got = [(m["set"], m["member"], [int(u) for u in e.user_inputs])
           for m, (_, _, e) in zip(members, envs)]
    ends = [first for _, first, _ in steps[1:]] + [len(got)]
    for (label, first, wall), end in zip(steps, ends):
        print(f"merged {label}: {end - first} member proofs, each wrapped, in {wall:.3f} s; "
              f"{card}")
    for (label, first, _), end, g in zip(steps[:2], ends, mg["host"]["blocks_100_101"]):
        own = got[first:end]
        assert [m for _, m, _ in own[:9]] == S.MERGED_PROOFS
        want = {c["set"]: c["pis"] for c in g["calls"][:5]}
        assert own[3][2][:31] == want["vx"][:31] and own[3][2][95] == 0
        assert own[5][2][:31] == want["vx_b"][:31] and own[5][2][95] == 0
        assert own[6][2][:len(want["cx"])] == want["cx"]
        assert own[7][2][:len(want["bx"])] == want["bx"]
        assert own[8][2] == want["fx"] == g["final"]
        assert [(s, m, p) for s, m, p in own[9:]] == [
            (c["set"], c["member"], c["pis"]) for c in g["calls"][5:]], label
    members_101 = [m for _, m, _ in got[ends[0]:ends[1]]]
    assert "block_parent_bound" in members_101 and "ivc_subsequent" in members_101
    gq = mg["host"]["query"]
    assert got[ends[1]:] == [(c["set"], c["member"], c["user_pis"]) for c in gq["calls"]]
    assert [int(u) for u in reveal] == gq["reveal"] and env.member == gq["member"]
    assert S._query_result_record(res) == gq["result"] and res.rows == [[720, 370]]
    revealed = [int("".join(f"{limb:08x}" for limb in reveal[i:i + 8]), 16) for i in (12, 20)]
    assert revealed == [720, 370]
    print(f"merged table on the card: set-up {setup:.3f} s (" + ", ".join(
        f"{k} {sum(w):.3f} s" for k, w in walls.items()) + f"), then "
        + ", ".join(f"{label} {wall:.3f} s" for label, _, wall in steps) + f"; {card}")
