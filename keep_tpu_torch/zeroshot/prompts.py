"""Prompt-ensemble generation from the Disease-Ontology knowledge graph
(counterpart of ``keep_tpu/zeroshot/prompts.py``).

The reference ships prompt JSONs (WSI_evaluation/prompts/*.json: ~1,400
entries of {classnames: {label: phrasing}, templates}) but not the tool that
builds them. This generates the same structure from a DO node: the tumor
phrasings are the node's name + synonyms + ancestor-path variants + template
wrappings, crossed with normal-tissue phrasings — ready for
``build_classifiers_batched`` + ``prompt_select`` screening.
"""

from __future__ import annotations

from typing import Optional, Sequence

from keep_tpu_torch.train.data import (
    HIERARCHY_TEMPLATES,
    NORMAL_NAMES,
    SUB_DISEASE_ROOTS,
)

DEFAULT_NORMAL_PHRASES = NORMAL_NAMES + ["benign tissue", "normal"]


def tumor_phrasings(nodes: dict, node_id: str, max_depth: int = 2) -> list[str]:
    """Name + synonyms of the node and its ancestors (up to ``max_depth``
    levels, stopping at the 8 DO roots), plus coarse→fine path phrases."""
    out: list[str] = []
    seen = set()

    def add(s: str):
        s = s.strip()
        if s and s.lower() not in seen:
            seen.add(s.lower())
            out.append(s)

    def names(nid):
        return [nodes[nid]["name"]] + list(nodes[nid].get("synonyms", []))

    for n in names(node_id):
        add(n)
    # frontier entries carry the contiguous coarse→fine suffix below the
    # node, so depth-2 phrases read "grandparent parent leaf" — the exact
    # shape hierarchy_caption trains the text tower on (full reversed path,
    # train/data.py:127-129), not a "grandparent leaf" skip
    frontier = [(node_id, nodes[node_id]["name"])]
    visited = {node_id}
    for _ in range(max_depth):
        nxt = []
        for nid, suffix in frontier:
            for parent in nodes[nid].get("parent", []):
                if parent in SUB_DISEASE_ROOTS or parent not in nodes:
                    continue
                for pn in names(parent):
                    add(pn)
                    # coarse → fine path phrase (hierarchy-caption order)
                    add(f"{pn} {suffix}")
                if parent not in visited:  # DO is a DAG — expand each once
                    visited.add(parent)
                    nxt.append((parent, f"{nodes[parent]['name']} {suffix}"))
        frontier = nxt
    return out


def generate_prompts(
    nodes: dict,
    tumor_node_id: str,
    normal_phrases: Sequence[str] = DEFAULT_NORMAL_PHRASES,
    templates: Optional[Sequence[str]] = None,
    tumor_label: str = "Tumor",
    normal_label: str = "Normal",
) -> dict:
    """→ {index: {classnames: {Normal: ..., Tumor: ...}, templates: str}}
    in the reference prompt-JSON format (one template per entry, the shipped
    files' shape)."""
    templates = list(HIERARCHY_TEMPLATES if templates is None else templates)
    tumors = tumor_phrasings(nodes, tumor_node_id)
    prompts = {}
    idx = 0
    for template in templates:
        for tumor in tumors:
            for normal in normal_phrases:
                prompts[str(idx)] = {
                    "classnames": {normal_label: normal, tumor_label: tumor},
                    "templates": template,
                }
                idx += 1
    return prompts
