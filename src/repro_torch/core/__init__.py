"""Core of the paper's contribution, ported to torch: rank-addressable
(combinatorial-addition) enumeration of column subsets and the Radic
determinant built on it, planned and routed by the engine."""

from .pascal import binom_table, comb, paper_table
from .unrank import (first_member, last_member, rank_py, rank_torch,
                     successor_py, successor_torch, unrank_py, unrank_torch)
from .paper_reference import combinatorial_addition, grain_sequence
from .radic import (aot_compile_batched, make_batched_evaluator, radic_det,
                    radic_det_batched, radic_sign, signed_minor_sum,
                    signed_minor_sum_batched)
from .engine import (DetEngine, DetPlan, PlanKey, default_engine,
                     plan_statics, rank_table, set_default_engine,
                     stable_key_hash, validate_rank_space)
from .oracle import combinations_lex, radic_det_exact, radic_det_oracle

__all__ = [
    "binom_table", "comb", "paper_table",
    "first_member", "last_member", "rank_py", "rank_torch",
    "successor_py", "successor_torch", "unrank_py", "unrank_torch",
    "combinatorial_addition", "grain_sequence",
    "aot_compile_batched", "make_batched_evaluator", "radic_det",
    "radic_det_batched",
    "radic_sign", "signed_minor_sum", "signed_minor_sum_batched",
    "DetEngine", "DetPlan", "PlanKey", "default_engine",
    "set_default_engine", "plan_statics", "rank_table",
    "stable_key_hash", "validate_rank_space",
    "combinations_lex", "radic_det_exact", "radic_det_oracle",
]
