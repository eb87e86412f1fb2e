"""Task registry + grouping rules for the omics benchmark evaluator.

Data mirrored from the reference registry
(the reference's eval/register_tasks.json:1-146) and the merge/rename logic
in the reference's eval/eval.py:832-975. Each entry: type (drives the
processing pipeline), answer-format hint, omics group, and headline metric.
"""

from __future__ import annotations

from typing import Dict, List

TASK_REGISTRY: Dict[str, dict] = {
    "emp": {"type": "binary classification", "omics": "DNA", "metrics": "MCC",
            "hint": "Return yes or no."},
    "pd": {"type": "binary classification", "omics": "DNA", "metrics": "MCC",
           "hint": "Return yes or no."},
    "cpd": {"type": "binary classification", "omics": "DNA", "metrics": "MCC",
            "hint": "Return yes or no."},
    "promoter_enhancer_interaction": {
        "type": "binary classification", "omics": "Multi", "metrics": "MCC",
        "hint": "Return yes or no."},
    "rna_protein_interaction": {
        "type": "binary classification", "omics": "Multi", "metrics": "MCC",
        "hint": "Return yes or no."},
    "antibody_antigen": {
        "type": "binary classification", "omics": "Multi", "metrics": "MCC",
        "hint": "Return yes or no."},
    "tf_h": {"type": "binary classification", "omics": "DNA",
             "metrics": "MCC", "hint": "Return yes or no."},
    "tf_m": {"type": "binary classification", "omics": "DNA",
             "metrics": "MCC", "hint": "Return yes or no."},
    "tf": {"type": "binary classification", "omics": "DNA", "metrics": "MCC",
           "hint": "Return yes or no."},
    "enhancer_activity": {
        "type": "multilabel regression", "omics": "DNA", "metrics": "PCC",
        "hint": "Return two numeric values with two decimal places for the "
                "regression values of 'Housekeeping enhancer activity' and "
                "'Developmental enhancer activity'."},
    "Fluorescence": {"type": "regression", "omics": "Protein",
                     "metrics": "spearman",
                     "hint": "Return one numeric value with two decimals."},
    "FunctionEC": {
        "type": "multilabel classification", "omics": "Protein",
        "metrics": "Fmax",
        "hint": "Return a string including one or more Enzyme Commission "
                "numbers, each composed of four numbers separated by "
                "periods. For example, 2.7.11.12"},
    "Solubility": {"type": "binary classification", "omics": "Protein",
                   "metrics": "Acc", "hint": "Return yes or no."},
    "Stability": {"type": "regression", "omics": "Protein",
                  "metrics": "spearman",
                  "hint": "Return one numeric value with two decimals."},
    "Thermostability": {"type": "regression", "omics": "Protein",
                        "metrics": "spearman",
                        "hint": "Return one numeric value with two decimals."},
    "Isoform": {"type": "regression", "omics": "RNA", "metrics": "R2",
                "hint": "Return one numeric value in two decimals."},
    "NoncodingRNAFamily": {
        "type": "multiclass classification", "omics": "RNA", "metrics": "Acc",
        "hint": "Return one of the 13 RNA class names."},
    "Modification": {
        "type": "multilabel classification", "omics": "RNA", "metrics": "AUC",
        "hint": "Return one, or more RNA modification names."},
    "MeanRibosomeLoading": {"type": "regression", "omics": "RNA",
                            "metrics": "R2",
                            "hint": "Return a numeric value in two decimals."},
    "ProgrammableRNASwitches": {
        "type": "multilabel regression", "omics": "RNA", "metrics": "R2",
        "hint": "Return three numeric values with two decimal places for "
                "the regression values of 'ON', 'OFF', and 'ON/OFF'."},
    "CRISPROnTarget": {"type": "regression", "omics": "RNA",
                       "metrics": "spearman",
                       "hint": "Return a numeric value in two decimals."},
    "sirnaEfficiency": {"type": "regression", "omics": "Multi",
                        "metrics": "mixed_score",
                        "hint": "Return a numeric value in two decimals."},
    "AntibodyAntigen": {
        "type": "binary classification", "omics": "Multi", "metrics": "MCC",
        "hint": "Return yes or no."},
    "ncRNAProteinInter": {
        "type": "binary classification", "omics": "Multi", "metrics": "MCC",
        "hint": "Return yes or no."},
}

# task renames applied at load (eval.py:854-861)
TASK_RENAMES = {
    "rna_protein_interaction": "ncRNAProteinInter",
    "antibody_antigen": "AntibodyAntigen",
}
TASK_NAME_SUBSTITUTIONS = (("tf-h", "tf_h"), ("tf-m", "tf_m"))

# fixed subtask -> merged-group map (eval.py:887-902); emp-* and
# promoter_enhancer_interaction-* groups are auto-collected at runtime.
SUBTASK_GROUPS: Dict[str, List[str]] = {
    "pd": ["pd-prom_300_tata", "pd-prom_300_all", "pd-prom_300_notata"],
    "cpd": ["cpd-prom_core_all", "cpd-prom_core_tata",
            "cpd-prom_core_notata"],
    "tf_m": [f"tf_m-{i}" for i in range(5)],
    "tf_h": [f"tf_h-{i}" for i in range(5)],
}

AUTO_GROUP_PREFIXES = ("emp", "promoter_enhancer_interaction")


def get_base_task_name(task_name: str) -> str:
    """Resolve a (sub)task name to its registry key (eval.py:950-975)."""
    if task_name in TASK_REGISTRY:
        return task_name
    if task_name.startswith("pd-prom_300_"):
        return "pd"
    if task_name.startswith("cpd-prom_core_"):
        return "cpd"
    if task_name.startswith("tf_m-"):
        return "tf_m"
    if task_name.startswith("tf_h-"):
        return "tf_h"
    if task_name.startswith("tf-"):
        return "tf"
    base = task_name.split("-")[0]
    if base in TASK_REGISTRY:
        return base
    raise KeyError(f"Task name {task_name!r} not in registry and no base "
                   "task could be inferred")
