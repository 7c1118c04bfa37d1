"""The port's circuit parameters and fixed-data cache against mp2_tpu on the
CPU: deterministic params, verification from reloaded `VerifierData`, the
npz round trip (as tests/test_params.py:23-60), equal `VerifierData` bytes
in both packages, and the MP2_FIXED_CACHE disk cache read across packages
in both directions: the same file, the same circuit digest, the same proof
bytes."""

import glob
import os

import pytest

from mp2_tpu.circuit.builder import CircuitBuilder as JCircuitBuilder
from mp2_tpu.prover import params as JPP
from mp2_tpu.prover import prove as jprove
from mp2_tpu.prover.config import test_config as jtest_config
from mp2_tpu.prover.serde import proof_to_dict as jproof_to_dict
from mp2_tpu_torch.circuit.builder import CircuitBuilder
from mp2_tpu_torch.field.goldilocks import P
from mp2_tpu_torch.prover import params as PP
from mp2_tpu_torch.prover import prove
from mp2_tpu_torch.prover.config import test_config
from mp2_tpu_torch.prover.serde import proof_sha256, proof_to_dict
from mp2_tpu_torch.prover.verify import verify


def _define(b):
    x = b.add_input()
    out = b.add_const(b.mul(x, x), 7)
    b.register_public_input(out)
    return x


def _build():
    b = CircuitBuilder(test_config())
    x = _define(b)
    return b.build("cpu"), x


def _jbuild():
    b = JCircuitBuilder(jtest_config())
    x = _define(b)
    return b.build(), x


def _proof_sha(data, x, pkg_prove, to_dict):
    w = data.generate_witness({x: 5})
    return proof_sha256(to_dict(pkg_prove(data, w, [(25 + 7) % P])))


def test_deterministic_params():
    d1, _ = _build()
    d2, _ = _build()
    assert d1.circuit_digest == d2.circuit_digest
    assert PP.verifier_data_to_bytes(PP.verifier_data(d1)) == (
        PP.verifier_data_to_bytes(PP.verifier_data(d2))
    )


def test_verify_from_reloaded_params():
    data, x = _build()
    w = data.generate_witness({x: 5})
    proof = prove.prove(data, w, [(25 + 7) % P])

    vd = PP.verifier_data_from_bytes(
        PP.verifier_data_to_bytes(PP.verifier_data(data))
    )
    assert vd.circuit_digest == data.circuit_digest
    assert verify(vd, proof)
    proof.public_inputs = [33]
    assert not verify(vd, proof)


def test_npz_roundtrip(tmp_path):
    data, _ = _build()
    path = str(tmp_path / "params.npz")
    PP.save_fixed_columns(data, path)
    vd = PP.load_verifier_data(path)
    assert vd.circuit_digest == data.circuit_digest
    assert vd.fixed_cap_host == data.fixed_cap_host


def test_verifier_data_bytes_equal_the_reference():
    """Both packages serialise the same circuit's VerifierData to the same
    bytes, and each reads the other's: a verifier of either package checks
    a proof against parameters the other wrote."""
    data, x = _build()
    jdata, _ = _jbuild()
    ours = PP.verifier_data_to_bytes(PP.verifier_data(data))
    theirs = JPP.verifier_data_to_bytes(JPP.verifier_data(jdata))
    assert ours == theirs
    w = data.generate_witness({x: 5})
    assert verify(PP.verifier_data_from_bytes(theirs),
                  prove.prove(data, w, [(25 + 7) % P]))


def _boom(*_args, **_kwargs):
    raise AssertionError("the fixed data was computed, not read from the cache")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_fixed_cache_is_read_across_packages(writer, tmp_path, monkeypatch):
    """With MP2_FIXED_CACHE set, the package that compiles first writes
    fixed_{key}.npz; the other package's compile reads it (its own iNTT is
    never called) and gives the same circuit digest and the same proof."""
    monkeypatch.setenv("MP2_FIXED_CACHE", str(tmp_path))
    first, second = (_jbuild, _build) if writer == "ref" else (_build, _jbuild)
    reader_ntt = prove.ntt if writer == "ref" else jprove.ntt
    a, ax = first()
    files = glob.glob(os.path.join(tmp_path, "fixed_*.npz"))
    assert len(files) == 1 and len(os.path.basename(files[0])) == len("fixed_.npz") + 32
    with monkeypatch.context() as m:
        m.setattr(reader_ntt, "intt", _boom)
        b, bx = second()
    assert glob.glob(os.path.join(tmp_path, "*")) == files  # no second file, no .tmp
    assert a.circuit_digest == b.circuit_digest
    assert a.fixed_cap_host == b.fixed_cap_host
    data, x = (b, bx) if writer == "ref" else (a, ax)
    jdata, jx = (a, ax) if writer == "ref" else (b, bx)
    assert _proof_sha(data, x, prove.prove, proof_to_dict) == _proof_sha(
        jdata, jx, jprove.prove, jproof_to_dict)


def test_fixed_cache_off_unless_set(tmp_path, monkeypatch):
    monkeypatch.delenv("MP2_FIXED_CACHE", raising=False)
    monkeypatch.chdir(tmp_path)
    _build()
    assert os.listdir(tmp_path) == []
