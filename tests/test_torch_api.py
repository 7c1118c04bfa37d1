"""The port's proving API (`api.py`) against mp2_tpu on the CPU.

`api.generate_proof`, `api.verify_envelope` and `api.build_circuits_params`
are held against the reference without building a circuit:

  * every CircuitInput kind (`block`, `contract`, `values_trie` for table a
    and table b, `final_simple`, `final_merge`, `cells_tree`, `rows_node` as
    a leaf, a full and a partial node, `block_node` plain and bound, leaf
    and parent, `ivc` first and subsequent) is fed to both packages'
    `generate_proof` as the same serialized dict, over stand-in
    PublicParameters whose sets record each call: the records (set, method,
    arguments, with every envelope by its serialized dict) must be equal.
    The payloads are the merged table's block 100 (chip_smoke.py's table
    with the single slot 9): its header, state path and both storage walks;
  * an unknown kind raises ValueError in both; `length` and
    `final_lengthed` raise NotImplementedError in the port (ROADMAP Queue 1
    item 3b.3) and never reach a set;
  * `verify_envelope` routes an envelope to the sets that own its member, in
    the same order in both packages, over stand-in sets;
  * `build_circuits_params` builds the same sets with the same arguments
    (each package's set classes replaced by recorders at test time), the
    port on the device it is given; with `length_slot` it raises before any
    set is built;
  * a WrappedEnvelope's dict round trip (numpy-seeded proof fields).

The tolerance is 0: every compared value is an integer, a byte string or a
string.
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import mp2_tpu.api as japi
import mp2_tpu.extraction.storage_key as jsk
import mp2_tpu.models.pipeline as jpipeline
import mp2_tpu.recursion.runtime as jruntime
import mp2_tpu_torch.api as api
import mp2_tpu_torch.extraction.storage_key as sk
import mp2_tpu_torch.models.pipeline as pipeline
import mp2_tpu_torch.recursion.runtime as runtime
from mp2_tpu_torch.extraction.mpt_circuits import host_key_nibbles

PKGS = {"port": SimpleNamespace(api=api, pipe=pipeline, sk=sk, rt=runtime),
        "ref": SimpleNamespace(api=japi, pipe=jpipeline, sk=jsk, rt=jruntime)}
ADDR = bytes(range(20))  # chip_smoke.py's table
CHAIN_ID, SLOT, SINGLE_SLOT = 1, 4, 9
BLOCKS = ({b"\x11": 100, b"\x22": 250}, {b"\x11": 120, b"\x22": 250})
SUPPLY = (350, 370)
P = (1 << 64) - (1 << 32) + 1


def _chain(pkg, merged=True):
    m = PKGS[pkg].pipe
    if merged:
        cfg = m.MergedTableConfig(ADDR, CHAIN_ID, SLOT, single_slot=SINGLE_SLOT)
        return cfg, m.make_chain(cfg, BLOCKS, single_values=SUPPLY)
    cfg = m.MappingTableConfig(ADDR, CHAIN_ID, SLOT)
    return cfg, m.make_chain(cfg, BLOCKS)


def _env_dict(seed, member, n_pis=8):
    """A WrappedEnvelope's dict with numpy-seeded proof fields."""
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64).tolist()

    return {"member": member, "proof": {
        "wires_cap": ints(2, 4), "zs_cap": ints(2, 4), "quotient_cap": ints(2, 4),
        "openings": {k: ints(3, 2) for k in ("fixed", "wires", "zs_partials", "quotient",
                                             "zs_next")},
        "fri": {"commit_caps": [ints(2, 4)], "final_poly": ints(2, 2),
                "pow_witness": int(rng.integers(0, 1 << 20)),
                "query_rounds": [{"initial_leaves": [ints(5)], "initial_siblings": [ints(3, 4)],
                                  "steps": [{"pair": ints(2, 2), "siblings": ints(2, 4)}]}]},
        "public_inputs": ints(n_pis)}}


def _norm(x):
    """A recorded argument in a form both packages share."""
    if hasattr(x, "to_dict"):
        return ("env", x.to_dict())
    if hasattr(x, "to_fields"):
        return ("point", [int(v) for v in x.to_fields()])
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_norm(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return sorted((_norm(k), _norm(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, bytes):
        return x.hex()
    if isinstance(x, (bool, int, np.integer)):
        return int(x)
    if x is None or isinstance(x, str):
        return x
    return (type(x).__name__, _norm(vars(x)))


class _Result:
    def __init__(self, index):
        self.index = index

    def to_dict(self):
        return {"result": self.index}


class _Recorder:
    """Stands for one set: each method call is logged with its arguments
    and answered with a result that serializes to its index."""

    def __init__(self, name, log, pairs=True):
        self.name, self.log, self.pairs = name, log, pairs

    def __getattr__(self, method):
        def call(*args, **kw):
            self.log.append((self.name, method, _norm(args), _norm(kw)))
            out = _Result(len(self.log) - 1)
            return (out, None) if self.pairs else out

        return call


def _params(log):
    """Stand-in PublicParameters: the extraction sets answer (envelope, PIs),
    the verifiable DB's sets an envelope."""
    vdb = SimpleNamespace(prove_cells_tree=_Recorder("vdb", log, pairs=False).prove_cells_tree,
                          **{n: _Recorder(n, log, pairs=False)
                             for n in ("cells", "rows", "block", "ivc")})
    return SimpleNamespace(vx=_Recorder("vx", log), vx_b=_Recorder("vx_b", log),
                           cx=_Recorder("cx", log), bx=_Recorder("bx", log),
                           fx=_Recorder("fx", log), vdb=vdb, lx=None)


def _inputs():
    """One serialized CircuitInput per case, over block 100 of the merged
    table."""
    cfg, chain = _chain("port")
    blk = chain[0]
    keys = sorted(blk.entries)
    loc = sk.simple_slot_location(SINGLE_SLOT)
    env = {name: _env_dict(i, name) for i, name in enumerate(
        ("block", "contract", "values", "table_b", "cells", "rows_l", "rows_r", "rows_root",
         "extraction", "block_l", "block_r", "previous"))}
    return {
        "block": {"kind": "block", "header": blk.header_rlp.hex()},
        "contract": {"kind": "contract", "proof_nodes": [
            n.hex() for n in blk.state.get_proof(cfg.contract_address)]},
        "values_trie a": {"kind": "values_trie", "paths": [
            [n.hex() for n in blk.storage.get_proof(sk.mapping_location(SLOT, k))]
            for k in keys], "leaf_args": [k.hex() for k in keys]},
        "values_trie b": {"kind": "values_trie", "table": "b", "paths": [
            [n.hex() for n in blk.storage.get_proof(loc)]],
            "leaf_args": [[int(v) for v in host_key_nibbles(loc)]]},
        "values_trie b, evm word": {"kind": "values_trie", "table": "b", "paths": [
            [n.hex() for n in blk.storage.get_proof(loc)]],
            "leaf_args": [[[int(v) for v in host_key_nibbles(loc)], 0]]},
        "final_simple": {"kind": "final_simple", "block": env["block"],
                         "contract": env["contract"], "values": env["values"]},
        "final_merge": {"kind": "final_merge", "block": env["block"],
                        "contract": env["contract"], "table_a": env["values"],
                        "table_b": env["table_b"], "is_table_a_multiplier": False},
        "final_merge, a multiplies": {"kind": "final_merge", "block": env["block"],
                                      "contract": env["contract"], "table_a": env["values"],
                                      "table_b": env["table_b"],
                                      "is_table_a_multiplier": True},
        "cells_tree": {"kind": "cells_tree", "cells": [
            {"identifier": int(cfg.value_id), "value": 100},
            {"identifier": int(cfg.supply_id), "value": 350, "is_multiplier": True}]},
        "rows_node leaf": {"kind": "rows_node", "secondary": {
            "identifier": int(cfg.key_id), "value": 0x11}, "row_unique_data": [1, 2, 3, 4],
            "cells": env["cells"], "claimed_pis": list(range(10))},
        "rows_node full": {"kind": "rows_node", "secondary": {
            "identifier": int(cfg.key_id), "value": 0x22}, "row_unique_data": [5, 6, 7, 8],
            "cells": env["cells"], "children": [env["rows_l"], env["rows_r"]],
            "claimed_pis": list(range(10, 20))},
        "rows_node partial": {"kind": "rows_node", "secondary": {
            "identifier": int(cfg.key_id), "value": 0x22}, "row_unique_data": [5, 6, 7, 8],
            "cells": env["cells"], "children": [env["rows_l"]], "child_is_left": True,
            "claimed_pis": list(range(20, 30))},
        "block_node leaf": {"kind": "block_node", "rows_root": env["rows_root"],
                            "index_id": int(cfg.block_id), "block_number": 100,
                            "claimed_pis": list(range(30, 40))},
        "block_node leaf bound": {"kind": "block_node", "rows_root": env["rows_root"],
                                  "extraction": env["extraction"], "is_merge": True,
                                  "index_id": int(cfg.block_id), "block_number": 100,
                                  "claimed_pis": list(range(40, 50))},
        "block_node parent bound": {"kind": "block_node", "rows_root": env["rows_root"],
                                    "extraction": env["extraction"], "is_merge": True,
                                    "children": [env["block_l"], env["block_r"]],
                                    "has_right": True, "index_id": int(cfg.block_id),
                                    "block_number": 101, "claimed_pis": list(range(50, 60))},
        "block_node parent": {"kind": "block_node", "rows_root": env["rows_root"],
                              "children": [env["block_l"], env["block_l"]],
                              "has_right": False, "index_id": int(cfg.block_id),
                              "block_number": 100, "claimed_pis": list(range(60, 70))},
        "ivc first": {"kind": "ivc", "block_root": env["block_l"], "latest_block": 100,
                      "metadata_hash": [1, 2, 3, 4], "claimed_pis": list(range(70, 80))},
        "ivc subsequent": {"kind": "ivc", "block_root": env["block_r"],
                           "previous": env["previous"], "latest_block": 101,
                           "claimed_pis": list(range(80, 90))},
    }


INPUTS = _inputs()
WANT = {"block": ("bx", "prove_header"), "contract": ("cx", "prove_state_path"),
        "values_trie a": ("vx", "prove_trie"), "values_trie b": ("vx_b", "prove_trie"),
        "values_trie b, evm word": ("vx_b", "prove_trie"), "final_simple": ("fx", "prove"),
        "final_merge": ("fx", "prove_merge"), "final_merge, a multiplies": ("fx", "prove_merge"),
        "cells_tree": ("vdb", "prove_cells_tree"),
        "rows_node leaf": ("rows", "prove_aggregation"),
        "rows_node full": ("rows", "prove_aggregation"),
        "rows_node partial": ("rows", "prove_aggregation"),
        "block_node leaf": ("block", "prove_aggregation"),
        "block_node leaf bound": ("block", "prove_aggregation"),
        "block_node parent bound": ("block", "prove_aggregation"),
        "block_node parent": ("block", "prove_aggregation"),
        "ivc first": ("ivc", "prove_aggregation"),
        "ivc subsequent": ("ivc", "prove_aggregation")}


@pytest.mark.parametrize("case", list(INPUTS))
def test_generate_proof_calls_as_reference(case):
    logs, outs = {}, {}
    for pkg in PKGS:
        logs[pkg] = []
        outs[pkg] = PKGS[pkg].api.generate_proof(_params(logs[pkg]), INPUTS[case])
    assert logs["port"] == logs["ref"]
    assert outs["port"] == outs["ref"] == {"result": 0}
    ((set_name, method, args, kw),) = logs["port"]
    assert (set_name, method) == WANT[case]
    if method == "prove_aggregation":
        member = args[0]
        assert member.startswith(set_name + "_")
        if case.startswith("block_node"):
            assert member.endswith("_bound") == ("bound" in case)
    if case.startswith("final_merge"):
        assert dict(kw)["is_table_a_multiplier"] == int("a multiplies" in case)


@pytest.mark.parametrize("kind", ["nope", "length", "final_lengthed"])
def test_unknown_and_length_kinds_refused(kind):
    log = []
    if kind == "nope":
        for pkg in PKGS:
            with pytest.raises(ValueError):
                PKGS[pkg].api.generate_proof(_params(log), {"kind": kind})
    else:
        with pytest.raises(NotImplementedError, match="3b.3"):
            api.generate_proof(_params(log), {"kind": kind, "proof_nodes": []})
    assert log == []


class _Owner:
    """Stands for one set in verify_envelope: owns some member names and
    answers verify() as told, logging each call."""

    def __init__(self, name, members, accepts, log):
        self.name, self.members, self.accepts, self.log = name, set(members), accepts, log

    def verify(self, env):
        self.log.append((self.name, env.member, env.public_inputs))
        return self.accepts


ROUTES = {  # member, the sets whose verify accepts, whether vx_b exists
    "branch1 in vx_b": ("branch1", {"vx_b"}, True),
    "branch1 in vx": ("branch1", {"vx"}, True),
    "branch1, no vx_b": ("branch1", {"vx"}, False),
    "final_merge": ("final_merge", {"fx"}, True),
    "ivc_first": ("ivc_first", {"ivc"}, True),
    "rejected everywhere": ("branch1", set(), True),
    "no owner": ("unknown", {"vx", "fx"}, True),
}


def _route(pkg, member, accepting, with_b):
    log = []
    owners = {"vx": ["leaf_mapping", "branch1", "branch2"], "vx_b": ["leaf_single", "branch1"],
              "cx": ["account_leaf"], "bx": ["block"], "fx": ["final_simple", "final_merge"],
              "cells": ["cells_leaf"], "rows": ["rows_leaf"], "block": ["block_leaf_bound"],
              "ivc": ["ivc_first"]}
    fw = {n: _Owner(n, ms, n in accepting, log) for n, ms in owners.items()}
    params = SimpleNamespace(
        **{n: SimpleNamespace(fw=fw[n]) for n in ("vx", "cx", "bx", "fx")},
        vx_b=SimpleNamespace(fw=fw["vx_b"]) if with_b else None, lx=None,
        vdb=SimpleNamespace(**{n: fw[n] for n in ("cells", "rows", "block", "ivc")}))
    ok = PKGS[pkg].api.verify_envelope(params, _env_dict(7, member))
    return ok, log


@pytest.mark.parametrize("route", list(ROUTES))
def test_verify_envelope_routing_as_reference(route):
    member, accepting, with_b = ROUTES[route]
    ok, log = _route("port", member, accepting, with_b)
    assert (ok, log) == _route("ref", member, accepting, with_b)
    assert ok == (member != "unknown" and bool(accepting))
    assert all(m == member for _, m, _ in log)


SETS = ("ValuesExtractionCircuits", "ContractExtractionCircuits", "BlockExtractionFramework",
        "FinalExtractionCircuits", "VerifiableDbCircuits")


def _wiring(pkg, merged, arities, monkeypatch):
    """The sets build_circuits_params builds, each recorded with its
    arguments (every set by its construction index), and the params."""
    log, devices = [], []

    def recorder(cls_name):
        def build(*args, **kw):
            devices.append(kw.pop("device", None))
            log.append((cls_name, _norm(args), _norm(kw)))
            return SimpleNamespace(fw=SimpleNamespace(index=len(log) - 1), index=len(log) - 1)

        return build

    for name in SETS:
        monkeypatch.setattr(PKGS[pkg].api, name, recorder(name))
    cfg, chain = _chain(pkg, merged)
    kw = {"device": "cpu"} if pkg == "port" else {}
    params = PKGS[pkg].api.build_circuits_params(cfg, chain[0].header_rlp,
                                                 branch_arities=arities, **kw)
    fields = {f: getattr(params, f).index if hasattr(getattr(params, f), "index")
              else getattr(params, f) for f in ("vx", "vx_b", "cx", "bx", "fx", "vdb", "lx")}
    return log, devices, fields, params


@pytest.mark.parametrize("merged,arities", [(False, (1, 2, 3)), (True, (1, 2, 3)),
                                            (True, (1, 2))],
                         ids=["mapping", "merged", "merged, arities 1 2"])
def test_build_circuits_params_wiring_as_reference(merged, arities, monkeypatch):
    log, devices, fields, params = _wiring("port", merged, arities, monkeypatch)
    jlog, jdevices, jfields, jparams = _wiring("ref", merged, arities, monkeypatch)
    assert log == jlog and fields == jfields
    assert devices == ["cpu"] * len(log) and jdevices == [None] * len(log)
    built = [name for name, _, _ in log]
    assert built == ([SETS[0]] * (2 if merged else 1) + list(SETS[1:]))
    final_kw = dict(log[built.index("FinalExtractionCircuits")][2])
    assert (final_kw["merge_with"] is not None) == merged == (fields["vx_b"] is not None)
    if merged:
        assert dict(final_kw["merge_with"][1])["index"] == fields["vx_b"] == 1
    assert params.cfg is not None and params.lx is None and jparams.lx is None


def test_build_circuits_params_refuses_length_before_building(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a set was built before the length refusal")

    for name in SETS[:3] + SETS[4:]:
        monkeypatch.setattr(api, name, refuse)
    cfg, chain = _chain("port", merged=False)
    with pytest.raises(NotImplementedError, match="3b.3"):
        api.build_circuits_params(cfg, chain[0].header_rlp, length_slot=2, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wrapped_envelope_dict_round_trip_as_reference(seed):
    d = _env_dict(seed, "final_merge", n_pis=12)
    env = runtime.WrappedEnvelope.from_dict(d)
    jenv = jruntime.WrappedEnvelope.from_dict(d)
    assert env.to_dict() == jenv.to_dict()
    assert json.loads(json.dumps(env.to_dict())) == d  # as a worker receives it
    assert env.public_inputs == jenv.public_inputs == d["proof"]["public_inputs"]
    assert env.user_inputs == d["proof"]["public_inputs"][:-4]
    assert runtime.WrappedEnvelope.from_dict(env.to_dict()).to_dict() == env.to_dict()
