"""Graph construction, dictionary encoding and (de)serialisation.

The paper's memory optimisations (Sec. 4.4.3) — property-key bytes and string
interning — become *dictionary encoding* here: every key and every string
value is assigned an integer id at load time, and queries are rewritten
against the dictionaries (`GraphBuilder.encode_*`).  Vertices are permuted
into type-major order at build time (the tensor analogue of type-based
partitioning, Sec. 4.4.1).

Keys may be declared ``ordered=True``: their values must be non-negative ints
and are used as ids directly, preserving order so that min/max temporal
aggregation and range comparisons are meaningful.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import NO_VALUE, PropColumn, TemporalGraph, make_prop_column


class GraphBuilder:
    def __init__(self):
        self.v_type_ids: Dict[str, int] = {}
        self.e_type_ids: Dict[str, int] = {}
        self.key_ids: Dict[str, int] = {}
        self.key_ordered: Dict[int, bool] = {}
        self.value_dicts: Dict[int, Dict[str, int]] = {}
        self._v_types: List[int] = []
        self._v_lives: List[Tuple[int, int]] = []
        self._edges: List[Tuple[int, int, int, int, int]] = []
        self._vprop_rows: Dict[int, List[Tuple[int, int, int, int]]] = {}
        self._eprop_rows: Dict[int, List[Tuple[int, int, int, int]]] = {}
        self.lifespan = (0, 1)

    # ----------------------------------------------------------- dictionaries
    def vertex_type(self, name: str) -> int:
        return self.v_type_ids.setdefault(name, len(self.v_type_ids))

    def edge_type(self, name: str) -> int:
        return self.e_type_ids.setdefault(name, len(self.e_type_ids))

    def key(self, name: str, ordered: bool = False) -> int:
        k = self.key_ids.setdefault(name, len(self.key_ids))
        self.key_ordered.setdefault(k, ordered)
        if not ordered:
            self.value_dicts.setdefault(k, {})
        return k

    def encode_value(self, key: int, value) -> int:
        if self.key_ordered[key]:
            v = int(value)
            assert v >= 0, "ordered keys need non-negative int values"
            return v
        d = self.value_dicts[key]
        s = str(value)
        return d.setdefault(s, len(d))

    def lookup_value(self, key: int, value) -> int:
        """Encode without inserting (query rewrite); -2 if unseen (matches nothing)."""
        if self.key_ordered[key]:
            return int(value)
        return self.value_dicts[key].get(str(value), -2)

    # ------------------------------------------------------------- structure
    def add_vertex(self, vtype: int, life: Tuple[int, int]) -> int:
        self._v_types.append(vtype)
        self._v_lives.append((int(life[0]), int(life[1])))
        return len(self._v_types) - 1

    def add_edge(self, src: int, dst: int, etype: int, life: Tuple[int, int]) -> int:
        self._edges.append((src, dst, etype, int(life[0]), int(life[1])))
        return len(self._edges) - 1

    def set_vprop(self, vid: int, key: int, value, life: Optional[Tuple[int, int]] = None):
        if life is None:
            life = self._v_lives[vid]
        self._vprop_rows.setdefault(key, []).append(
            (vid, self.encode_value(key, value), int(life[0]), int(life[1]))
        )

    def set_eprop(self, eid: int, key: int, value, life: Optional[Tuple[int, int]] = None):
        if life is None:
            life = self._edges[eid][3:5]
        self._eprop_rows.setdefault(key, []).append(
            (eid, self.encode_value(key, value), int(life[0]), int(life[1]))
        )

    # ----------------------------------------------------------------- build
    def build(self) -> TemporalGraph:
        V = len(self._v_types)
        v_type = np.asarray(self._v_types, np.int32)
        v_life = np.asarray(self._v_lives, np.int32).reshape(V, 2)
        # type-major permutation (stable keeps generator locality within type)
        perm = np.argsort(v_type, kind="stable").astype(np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(V)
        v_type = v_type[perm]
        v_life = v_life[perm]

        if self._edges:
            earr = np.asarray(self._edges, np.int64)
            e_src = inv[earr[:, 0]].astype(np.int32)
            e_dst = inv[earr[:, 1]].astype(np.int32)
            e_type = earr[:, 2].astype(np.int32)
            e_life = earr[:, 3:5].astype(np.int32)
        else:
            e_src = e_dst = e_type = np.zeros(0, np.int32)
            e_life = np.zeros((0, 2), np.int32)

        vprops = {}
        for k, rows in self._vprop_rows.items():
            r = np.asarray(rows, np.int64)
            vprops[k] = make_prop_column(V, inv[r[:, 0]], r[:, 1], r[:, 2:4])
        eprops = {}
        for k, rows in self._eprop_rows.items():
            r = np.asarray(rows, np.int64)
            eprops[k] = make_prop_column(len(self._edges), r[:, 0], r[:, 1], r[:, 2:4])

        meta = dict(
            v_type_ids=dict(self.v_type_ids),
            e_type_ids=dict(self.e_type_ids),
            key_ids=dict(self.key_ids),
            key_ordered={str(k): v for k, v in self.key_ordered.items()},
            value_dicts={str(k): d for k, d in self.value_dicts.items()},
        )
        return TemporalGraph(
            v_type, v_life, e_src, e_dst, e_type, e_life, vprops, eprops,
            n_vertex_types=len(self.v_type_ids),
            n_edge_types=max(1, len(self.e_type_ids)),
            lifespan=self.lifespan,
            meta=meta,
        )


# ------------------------------------------------------------- serialisation
def save_graph(graph: TemporalGraph, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = dict(
        v_type=graph.v_type, v_life=graph.v_life,
        e_src=graph.e_src, e_dst=graph.e_dst, e_type=graph.e_type,
        e_life=graph.e_life,
    )
    for k, c in graph.vprops.items():
        arrs[f"vp{k}_vals"] = c.vals
        arrs[f"vp{k}_life"] = c.life
    for k, c in graph.eprops.items():
        arrs[f"ep{k}_vals"] = c.vals
        arrs[f"ep{k}_life"] = c.life
    np.savez_compressed(path, **arrs)
    meta = {k: v for k, v in graph.meta.items()
            if isinstance(v, (dict, list, str, int, float, bool, type(None)))}
    hdr = dict(
        n_vertex_types=graph.n_vertex_types,
        n_edge_types=graph.n_edge_types,
        lifespan=list(graph.lifespan),
        vprop_keys=sorted(graph.vprops),
        eprop_keys=sorted(graph.eprops),
        meta=meta,
    )
    with open(path + ".json", "w") as f:
        json.dump(hdr, f)


def load_graph(path: str) -> TemporalGraph:
    with open(path + ".json") as f:
        hdr = json.load(f)
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    vprops = {
        k: PropColumn(z[f"vp{k}_vals"], z[f"vp{k}_life"]) for k in hdr["vprop_keys"]
    }
    eprops = {
        k: PropColumn(z[f"ep{k}_vals"], z[f"ep{k}_life"]) for k in hdr["eprop_keys"]
    }
    return TemporalGraph(
        z["v_type"], z["v_life"], z["e_src"], z["e_dst"], z["e_type"], z["e_life"],
        vprops, eprops, hdr["n_vertex_types"], hdr["n_edge_types"],
        tuple(hdr["lifespan"]), meta=hdr.get("meta"),
    )
