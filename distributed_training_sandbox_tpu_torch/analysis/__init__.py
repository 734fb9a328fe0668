"""Partition rules, the collective contracts and their verdicts.

Port of the JAX package's ``analysis/rules.py`` (ordered regex rules
over named leaf paths, one ``RuleSet`` a strategy),
``analysis/contract_gen.py`` (each strategy's collective calls a step,
derived from its rules), ``analysis/contracts.py`` (the registry of
contracts and the verdict on a step's counts) and
``analysis/fixtures.py`` (every strategy's step at CPU size, built as its
twin builds it).  The reference's HLO readers (``hlo_lint``,
``recompile``, ``pitfalls``) are ROADMAP.md queue A item A12e.
"""

from .contract_gen import (ContractDiff, diff_all_contracts, diff_contract,
                           generate_counts)
from .contracts import (CONTRACTS, KINDS, CollectiveContract,
                        ContractContext, ContractVerdict, check_counts,
                        evaluate_contract, generated_contract,
                        parse_expected_spec)
from .rules import (RULESETS, MatchReport, Rule, RuleSet,
                    match_partition_rules, mirror_opt_rules,
                    named_leaf_paths, rules_manifest_verdict, spec_axes,
                    spec_str, tile_dims)

__all__ = ["CONTRACTS", "KINDS", "RULESETS", "CollectiveContract",
           "ContractContext", "ContractDiff", "ContractVerdict",
           "MatchReport", "Rule", "RuleSet", "check_counts",
           "diff_all_contracts", "diff_contract", "evaluate_contract",
           "generate_counts", "generated_contract", "match_partition_rules",
           "mirror_opt_rules", "named_leaf_paths", "parse_expected_spec",
           "rules_manifest_verdict", "spec_axes", "spec_str", "tile_dims"]
