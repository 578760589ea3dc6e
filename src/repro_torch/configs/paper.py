"""The paper's own workloads as selectable configs: the port's copy of
``repro/configs/paper.py``, field for field.

These drive the benchmarks (Tables 2-4, Figures 2-6) and the quickstart:
  listrank-<n>   random-splitter list ranking, n list nodes
  cc-<family>    Shiloach-Vishkin connected components per graph family
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ListRankConfig:
    name: str = "listrank"
    n: int = 8_000_000
    num_splitters: int = 8192
    pack_mode: str = "aos"  # soa | aos | word64
    seed: int = 0


@dataclass(frozen=True)
class CCConfig:
    name: str = "cc"
    graph_family: str = "random"  # list | tree | random
    n: int = 1_000_000
    m: int = 8_000_000
    tree_degree: int = 3
    density: float = 0.001
    seed: int = 0


LISTRANK_DEFAULT = ListRankConfig()
CC_DEFAULT = CCConfig()
