"""The paper's contribution: frequent-subgraph-analysis PE design-space
exploration (mine -> MIS-rank -> merge -> map -> evaluate)."""

from .costmodel import AppCost, evaluate_mapping
from .dse import DSEResult, PEVariant, domain_pe, mine_and_rank, specialize_per_app
from .isomorphism import Embedding, count_occurrences, find_embeddings, mni_support
from .mapper import Mapping, map_application
from .merge import add_pattern, baseline_datapath, is_pe_pattern, merge_subgraphs, validate_config
from .mining import MinedSubgraph, MiningConfig, mine_frequent_subgraphs
from .mis import maximal_independent_set, mis_of_occurrences, rank_by_mis
from .pe import Config, Datapath, single_op_pattern

__all__ = [
    "AppCost", "evaluate_mapping", "DSEResult", "PEVariant", "domain_pe",
    "mine_and_rank", "specialize_per_app", "Embedding", "count_occurrences",
    "find_embeddings", "mni_support", "Mapping", "map_application",
    "add_pattern", "baseline_datapath", "is_pe_pattern", "merge_subgraphs",
    "validate_config", "MinedSubgraph", "MiningConfig",
    "mine_frequent_subgraphs", "maximal_independent_set",
    "mis_of_occurrences", "rank_by_mis", "Config", "Datapath",
    "single_op_pattern",
]
