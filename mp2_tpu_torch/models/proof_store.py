"""Persistent proof storage keyed by typed stage keys (ProofKV role).

Reference: mp2-v1/tests/common/proof_storage.rs — `ProofKey` (typed,
prefix-hashed identifiers per pipeline stage, :60-137), the `ProofStorage`
trait (`store_proof` / `get_proof_exact` / `move_proof`, :138-156) and the
jammdb-backed `ProofKV` (:160-274).  Here the durable backend is sqlite
(stdlib, transactional) instead of jammdb; the key encoding is a canonical
JSON tuple rather than Rust's DefaultHasher (collision-free instead of
64-bit-hash-probably-fine).

`move_proof` exists for the secondary-index-change case: cells proofs are
keyed by their row's secondary value, so when that value changes the proofs
must be re-keyed (proof_storage.rs:141-155).

A copy of `mp2_tpu/models/proof_store.py` (which imports nothing of its
package): the port's pipeline keeps its envelopes here.
"""

from __future__ import annotations

import json
import pickle
import sqlite3
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Protocol, Tuple


def _enc(part: Any) -> Any:
    if isinstance(part, bytes):
        return {"b": part.hex()}
    if isinstance(part, (list, tuple)):
        return [_enc(p) for p in part]
    return part


@dataclass(frozen=True)
class ProofKey:
    """stage + identifier tuple; stages mirror proof_storage.rs ProofKey
    variants (cell/row/index/final_extraction/contract_extraction/
    block_extraction/value_extraction/ivc/query_universal/query_aggregate).
    """

    stage: str
    ident: Tuple = ()

    def encode(self) -> str:
        return json.dumps([self.stage, _enc(self.ident)],
                          separators=(",", ":"), sort_keys=True)

    # typed constructors -------------------------------------------------
    @staticmethod
    def cell(table: str, primary, secondary, tree_key) -> "ProofKey":
        return ProofKey("cell_tree", (table, primary, secondary, tree_key))

    @staticmethod
    def row(table: str, primary, tree_key) -> "ProofKey":
        return ProofKey("row_tree", (table, primary, tree_key))

    @staticmethod
    def index(table: str, tree_key) -> "ProofKey":
        return ProofKey("index_tree", (table, tree_key))

    @staticmethod
    def final_extraction(table: str, block: int) -> "ProofKey":
        return ProofKey("final_extract", (table, block))

    @staticmethod
    def contract_extraction(address: bytes, block: int) -> "ProofKey":
        return ProofKey("contract_extract", (address, block))

    @staticmethod
    def block_extraction(block: int) -> "ProofKey":
        return ProofKey("block_proof", (block,))

    @staticmethod
    def value_extraction(table: str, block: int) -> "ProofKey":
        return ProofKey("value_extract", (table, block))

    @staticmethod
    def ivc(block: int) -> "ProofKey":
        return ProofKey("ivc", (block,))

    @staticmethod
    def query_universal(query_id: str, placeholders, block,
                        row_key) -> "ProofKey":
        return ProofKey("query_universal",
                        (query_id, placeholders, block, row_key))

    @staticmethod
    def query_aggregate(query_id: str, placeholders, ut_key) -> "ProofKey":
        return ProofKey("query_aggregate", (query_id, placeholders, ut_key))


class ProofStorage(Protocol):
    def store_proof(self, key: ProofKey, proof: Any) -> None: ...
    def get_proof_exact(self, key: ProofKey) -> Any: ...
    def move_proof(self, old: ProofKey, new: ProofKey) -> None: ...


class MemoryProofStore:
    """Dict-backed store (tests / ephemeral workers)."""

    def __init__(self):
        self._d: Dict[str, Any] = {}

    def store_proof(self, key: ProofKey, proof: Any) -> None:
        self._d[key.encode()] = proof

    def get_proof_exact(self, key: ProofKey) -> Any:
        k = key.encode()
        if k not in self._d:
            raise KeyError(f"proof with key {k} not found")
        return self._d[k]

    def contains(self, key: ProofKey) -> bool:
        return key.encode() in self._d

    def move_proof(self, old: ProofKey, new: ProofKey) -> None:
        v = self._d.pop(old.encode(), None)
        if v is not None:
            self._d[new.encode()] = v

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> Iterator[str]:
        return iter(self._d)


class ProofDict:
    """Mapping facade over a ProofStorage for the pipelines' legacy tuple
    keys: `d[("stage", *ident)]` routes to the typed key
    ProofKey(stage, ident); with a fixed `stage`, `d[k]` routes to
    ProofKey(stage, (k,)).  Lets every stage artifact live in ONE durable
    store (SqliteProofKV) without changing call sites."""

    def __init__(self, store: ProofStorage, stage: Optional[str] = None):
        self.store = store
        self.stage = stage

    def _key(self, k) -> ProofKey:
        if self.stage is not None:
            ident = k if isinstance(k, tuple) else (k,)
            return ProofKey(self.stage, tuple(ident))
        assert isinstance(k, tuple) and k, "expected ('stage', *ident) key"
        return ProofKey(str(k[0]), tuple(k[1:]))

    def __setitem__(self, k, v) -> None:
        self.store.store_proof(self._key(k), v)

    def __getitem__(self, k):
        try:
            return self.store.get_proof_exact(self._key(k))
        except KeyError:
            raise KeyError(k) from None

    def __contains__(self, k) -> bool:
        try:
            self.store.get_proof_exact(self._key(k))
            return True
        except KeyError:
            return False

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __len__(self) -> int:
        """Entries in this facade's stage (all stages when unscoped)."""
        if self.stage is None:
            return len(self.store)
        prefix = json.dumps([self.stage], separators=(",", ":"))[:-1]
        return sum(1 for k in self.store.keys() if k.startswith(prefix))


class SqliteProofKV:
    """Durable proof store over sqlite (the jammdb ProofKV role): one
    `proofs(key TEXT PRIMARY KEY, blob)` table, transactional writes,
    pickle-serialized envelopes (WrappedEnvelope has to/from_dict, but any
    stage artifact is accepted)."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS proofs "
            "(key TEXT PRIMARY KEY, blob BLOB NOT NULL)"
        )
        self.conn.commit()

    def store_proof(self, key: ProofKey, proof: Any) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO proofs (key, blob) VALUES (?, ?)",
            (key.encode(), pickle.dumps(proof)),
        )
        self.conn.commit()

    def get_proof_exact(self, key: ProofKey) -> Any:
        row = self.conn.execute(
            "SELECT blob FROM proofs WHERE key = ?", (key.encode(),)
        ).fetchone()
        if row is None:
            raise KeyError(f"proof with key {key.encode()} not found")
        return pickle.loads(row[0])

    def contains(self, key: ProofKey) -> bool:
        return self.conn.execute(
            "SELECT 1 FROM proofs WHERE key = ?", (key.encode(),)
        ).fetchone() is not None

    def move_proof(self, old: ProofKey, new: ProofKey) -> None:
        row = self.conn.execute(
            "SELECT blob FROM proofs WHERE key = ?", (old.encode(),)
        ).fetchone()
        if row is None:
            return
        self.conn.execute(
            "INSERT OR REPLACE INTO proofs (key, blob) VALUES (?, ?)",
            (new.encode(), row[0]),
        )
        self.conn.execute("DELETE FROM proofs WHERE key = ?", (old.encode(),))
        self.conn.commit()

    def __len__(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM proofs").fetchone()[0]

    def keys(self) -> Iterator[str]:
        for (k,) in self.conn.execute("SELECT key FROM proofs"):
            yield k

    def close(self) -> None:
        self.conn.close()
