"""Partition rules and the collective contracts generated from them.

Port of the JAX package's ``analysis/rules.py`` (ordered regex rules
over named leaf paths, one ``RuleSet`` a strategy) and
``analysis/contract_gen.py`` (each strategy's collective calls a step,
derived from its rules).  The rest of the reference's ``analysis/``
(HLO lint, ledgers, fixtures) is ROADMAP.md queue A item A12.
"""

from .contract_gen import (ContractDiff, diff_all_contracts, diff_contract,
                           generate_counts)
from .rules import (RULESETS, MatchReport, Rule, RuleSet,
                    match_partition_rules, mirror_opt_rules,
                    named_leaf_paths, rules_manifest_verdict, spec_axes,
                    spec_str, tile_dims)

__all__ = ["RULESETS", "ContractDiff", "MatchReport", "Rule", "RuleSet",
           "diff_all_contracts", "diff_contract", "generate_counts",
           "match_partition_rules", "mirror_opt_rules", "named_leaf_paths",
           "rules_manifest_verdict", "spec_axes", "spec_str", "tile_dims"]
