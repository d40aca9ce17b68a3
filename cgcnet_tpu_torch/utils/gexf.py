"""GEXF export for qualitative cluster inspection in Gephi.

Port of ``cgcnet_tpu/utils/gexf.py`` (the reference's visualization dump,
``output_to_gexf``, common/utils.py:48-79): node coordinates plus the
hierarchical DiffPool cluster assignment at each level, deeper levels
composed through the level-1 mapping so every node carries its level-l
cluster id. The JAX package writes through ``networkx``; this one writes the
same GEXF 1.2 document (nodes, attributes, edges, in networkx's order) with
``xml.etree``, so it needs no package beyond the standard library.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

GEXF_NS = "http://www.gexf.net/1.2draft"
XSI_NS = "http://www.w3.org/2001/XMLSchema-instance"


def _compose_assignments(assign_list: list[np.ndarray]) -> dict[str, np.ndarray]:
    """argmax each [N_l, C_l] soft assignment and compose through levels:
    level-1 ids are per node; level-2 ids map through level 1, etc.
    (reference common/utils.py:55-69)."""
    hard = [np.argmax(a, axis=1) for a in assign_list]
    out = {"assign_1": hard[0]}
    current = hard[0]
    for lvl, deeper in enumerate(hard[1:], start=2):
        current = deeper[current]
        out[f"assign_{lvl}"] = current
    return out


def _edges(nbr: np.ndarray, nbr_mask: np.ndarray) -> tuple[list, list]:
    """(extra nodes, edges) of the ELL graph: the undirected edges without
    self loops, each once, in the order ``networkx.Graph.edges`` lists them
    after the same ``add_edge`` calls (row by row, slot by slot); a
    neighbour index past the rows becomes a node without attributes, as
    ``add_edge`` makes it."""
    n = nbr.shape[0]
    adj: dict[int, dict[int, None]] = {i: {} for i in range(n)}
    for i in range(n):
        for k in range(nbr.shape[1]):
            j = int(nbr[i, k])
            if nbr_mask[i, k] > 0 and j != i:
                adj[i].setdefault(j)
                adj.setdefault(j, {}).setdefault(i)
    seen: set[int] = set()
    edges = []
    for i, nb in adj.items():
        edges.extend((i, j) for j in nb if j not in seen)
        seen.add(i)
    return [j for j in adj if j >= n], edges


def graph_to_gexf(
    coords: np.ndarray,
    nbr: np.ndarray,
    nbr_mask: np.ndarray,
    path: str | Path,
    node_attrs: dict[str, np.ndarray] | None = None,
) -> None:
    """Write an ELL graph with coordinates (+ integer per-node attributes)
    to GEXF."""
    n = coords.shape[0]
    attrs = [("x", "double"), ("y", "double")] + [
        (k, "long") for k in (node_attrs or {})
    ]
    root = ET.Element("gexf", {
        "xmlns": GEXF_NS, "xmlns:xsi": XSI_NS,
        "xsi:schemaLocation": f"{GEXF_NS} {GEXF_NS}/gexf.xsd",
        "version": "1.2",
    })
    meta = ET.SubElement(root, "meta")
    ET.SubElement(meta, "creator").text = "cgcnet_tpu_torch"
    graph = ET.SubElement(root, "graph", {
        "defaultedgetype": "undirected", "mode": "static", "name": "",
    })
    decl = ET.SubElement(graph, "attributes", {"mode": "static", "class": "node"})
    for aid, (title, kind) in enumerate(attrs):
        ET.SubElement(decl, "attribute",
                      {"id": str(aid), "title": title, "type": kind})
    nodes = ET.SubElement(graph, "nodes")
    for i in range(n):
        node = ET.SubElement(nodes, "node", {"id": str(i), "label": str(i)})
        vals = ET.SubElement(node, "attvalues")
        values = [repr(float(coords[i, 0])), repr(float(coords[i, 1]))] + [
            str(int(v[i])) for v in (node_attrs or {}).values()
        ]
        for aid, value in enumerate(values):
            ET.SubElement(vals, "attvalue", {"for": str(aid), "value": value})
    extra, pairs = _edges(nbr, nbr_mask)
    for j in extra:
        ET.SubElement(nodes, "node", {"id": str(j), "label": str(j)})
    edges = ET.SubElement(graph, "edges")
    for eid, (i, j) in enumerate(pairs):
        ET.SubElement(edges, "edge",
                      {"source": str(i), "target": str(j), "id": str(eid)})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    ET.indent(root)
    ET.ElementTree(root).write(str(path), encoding="utf-8", xml_declaration=True)


def assignments_to_gexf(
    coords: np.ndarray,
    nbr: np.ndarray,
    nbr_mask: np.ndarray,
    assign_list: list[np.ndarray],
    path: str | Path,
    n_nodes: int | None = None,
) -> None:
    """Graph + composed hierarchical cluster labels -> GEXF (the eval-time
    dump behind --visualize, reference train.py:64-76)."""
    n = n_nodes if n_nodes is not None else coords.shape[0]
    # only level 1 is per node [N, C1]; deeper levels are [C_l, C_{l+1}]
    # cluster matrices whose rows are indexed by the previous level's cluster
    # ids — truncating those to n would drop valid cluster rows
    assigns = [np.asarray(assign_list[0])[:n]] + [
        np.asarray(a) for a in assign_list[1:]
    ]
    attrs = _compose_assignments(assigns)
    graph_to_gexf(coords[:n], nbr[:n], nbr_mask[:n], path, node_attrs=attrs)
