"""Model catalogue: the names ``resolve_model`` knows and refuses.

Counterpart of ``medaka_tpu/options.py``, trimmed to ``known_models``,
``deprecated_models`` and ``DeprecationError`` (and the current, archived
and basecaller lists ``known_models`` is built from). The port does not
download: a known model that is not on disk is an error.
"""
from __future__ import annotations

current_models = [
    "r1041_e82_400bps_hac_v5.2.0",
    "r1041_e82_400bps_sup_v5.2.0",
    "r1041_e82_400bps_hac_variant_v5.0.0",
    "r1041_e82_400bps_sup_variant_v5.0.0",
]

# basecaller model -> (consensus model, variant model)
basecaller_models = {
    "dna_r10.3_450bps_hac":
        ("r103_hac_g507", "r103_hac_variant_g507"),
    "dna_r10.3_450bps_hac_prom":
        ("r103_hac_g507", "r103_hac_variant_g507"),
    "dna_r10.4.1_e8.2_260bps_hac":
        ("r1041_e82_260bps_hac_g632", "r1041_e82_260bps_hac_variant_g632"),
    "dna_r10.4.1_e8.2_260bps_hac@v4.0.0":
        ("r1041_e82_260bps_hac_v4.0.0", None),
    "dna_r10.4.1_e8.2_260bps_hac@v4.1.0":
        ("r1041_e82_260bps_hac_v4.1.0",
         "r1041_e82_260bps_hac_variant_v4.1.0"),
    "dna_r10.4.1_e8.2_260bps_hac_prom":
        ("r1041_e82_260bps_hac_g632", "r1041_e82_260bps_hac_variant_g632"),
    "dna_r10.4.1_e8.2_260bps_sup@v4.0.0":
        ("r1041_e82_260bps_sup_v4.0.0", None),
    "dna_r10.4.1_e8.2_260bps_sup@v4.1.0":
        ("r1041_e82_260bps_sup_v4.1.0",
         "r1041_e82_260bps_sup_variant_v4.1.0"),
    "dna_r10.4.1_e8.2_400bps_hac":
        ("r1041_e82_400bps_hac_g632", "r1041_e82_400bps_hac_variant_g632"),
    "dna_r10.4.1_e8.2_400bps_hac@v3.5.1":
        ("r1041_e82_400bps_hac_g615", "r1041_e82_400bps_hac_variant_g615"),
    "dna_r10.4.1_e8.2_400bps_hac@v3.5.2":
        ("r1041_e82_400bps_hac_g632", "r1041_e82_400bps_hac_variant_g632"),
    "dna_r10.4.1_e8.2_400bps_hac@v4.0.0":
        ("r1041_e82_400bps_hac_v4.0.0", None),
    "dna_r10.4.1_e8.2_400bps_hac@v4.1.0":
        ("r1041_e82_400bps_hac_v4.1.0",
         "r1041_e82_400bps_hac_variant_v4.1.0"),
    "dna_r10.4.1_e8.2_400bps_hac@v4.2.0":
        ("r1041_e82_400bps_hac_v4.2.0",
         "r1041_e82_400bps_hac_variant_v4.2.0"),
    "dna_r10.4.1_e8.2_5khz_400bps_hac@v4.2.0":
        ("r1041_e82_400bps_hac_v4.2.0",
         "r1041_e82_400bps_hac_variant_v4.2.0"),
    "dna_r10.4.1_e8.2_400bps_hac@v4.3.0":
        ("r1041_e82_400bps_hac_v4.3.0",
         "r1041_e82_400bps_hac_variant_v4.3.0"),
    "dna_r10.4.1_e8.2_400bps_hac@v5.0.0":
        ("r1041_e82_400bps_hac_v5.0.0",
         "r1041_e82_400bps_hac_variant_v5.0.0"),
    "dna_r10.4.1_e8.2_400bps_hac@v5.2.0":
        ("r1041_e82_400bps_hac_v5.2.0",
         "r1041_e82_400bps_hac_variant_v5.0.0"),
    "dna_r10.4.1_e8.2_400bps_hac_prom":
        ("r1041_e82_400bps_hac_g632", "r1041_e82_400bps_hac_variant_g632"),
    "dna_r10.4.1_e8.2_400bps_sup@v3.5.2":
        ("r1041_e82_400bps_sup_g615", "r1041_e82_400bps_sup_variant_g615"),
    "dna_r10.4.1_e8.2_400bps_sup@v3.5.1":
        ("r1041_e82_400bps_sup_g615", "r1041_e82_400bps_sup_variant_g615"),
    "dna_r10.4.1_e8.2_400bps_sup@v4.0.0":
        ("r1041_e82_400bps_sup_v4.0.0", None),
    "dna_r10.4.1_e8.2_400bps_sup@v4.1.0":
        ("r1041_e82_400bps_sup_v4.1.0",
         "r1041_e82_400bps_sup_variant_v4.1.0"),
    "dna_r10.4.1_e8.2_400bps_sup@v4.2.0":
        ("r1041_e82_400bps_sup_v4.2.0",
         "r1041_e82_400bps_sup_variant_v4.2.0"),
    "dna_r10.4.1_e8.2_5khz_400bps_sup@v4.2.0":
        ("r1041_e82_400bps_sup_v4.2.0",
         "r1041_e82_400bps_sup_variant_v4.2.0"),
    "dna_r10.4.1_e8.2_400bps_sup@v4.3.0":
        ("r1041_e82_400bps_sup_v4.3.0",
         "r1041_e82_400bps_sup_variant_v4.3.0"),
    "dna_r10.4.1_e8.2_400bps_sup@v5.0.0":
        ("r1041_e82_400bps_sup_v5.0.0",
         "r1041_e82_400bps_sup_variant_v5.0.0"),
    "dna_r10.4.1_e8.2_400bps_sup@v5.2.0":
        ("r1041_e82_400bps_sup_v5.2.0",
         "r1041_e82_400bps_sup_variant_v5.0.0"),
    "dna_r9.4.1_e8_fast@v3.4":
        ("r941_min_fast_g507", "r941_min_fast_variant_g507"),
    "dna_r9.4.1_e8_hac@v3.3":
        ("r941_min_hac_g507", "r941_min_hac_variant_g507"),
    "dna_r9.4.1_e8_sup@v3.3":
        ("r941_min_sup_g507", "r941_min_sup_variant_g507"),
}

archived_models = [
    "r941_sup_plant_g610",
    "r941_min_fast_g507", "r941_prom_fast_g507",
    "r103_fast_g507", "r103_hac_g507", "r103_sup_g507",
    "r104_e81_fast_g5015", "r104_e81_sup_g5015", "r104_e81_hac_g5015",
    "r104_e81_sup_g610",
    "r104_e81_fast_variant_g5015", "r104_e81_hac_variant_g5015",
    "r104_e81_sup_variant_g610",
    "r1041_e82_400bps_hac_g615", "r1041_e82_400bps_fast_g615",
    "r1041_e82_400bps_fast_g632", "r1041_e82_260bps_fast_g632",
    "r1041_e82_400bps_hac_g632", "r1041_e82_400bps_sup_g615",
    "r1041_e82_260bps_hac_g632", "r1041_e82_260bps_sup_g632",
    "r1041_e82_400bps_hac_v4.0.0", "r1041_e82_400bps_sup_v4.0.0",
    "r1041_e82_260bps_hac_v4.0.0", "r1041_e82_260bps_sup_v4.0.0",
    "r1041_e82_260bps_hac_v4.1.0", "r1041_e82_260bps_sup_v4.1.0",
    "r1041_e82_400bps_hac_v4.1.0", "r1041_e82_400bps_sup_v4.1.0",
    "r1041_e82_400bps_hac_v4.2.0", "r1041_e82_400bps_sup_v4.2.0",
    "r1041_e82_400bps_hac_v4.3.0", "r1041_e82_400bps_sup_v4.3.0",
    "r1041_e82_400bps_hac_variant_g615",
    "r1041_e82_400bps_fast_variant_g615",
    "r1041_e82_400bps_fast_variant_g632",
    "r1041_e82_260bps_fast_variant_g632",
    "r1041_e82_400bps_hac_variant_g632",
    "r1041_e82_400bps_sup_variant_g615",
    "r1041_e82_260bps_hac_variant_g632",
    "r1041_e82_260bps_sup_variant_g632",
    "r1041_e82_260bps_hac_variant_v4.1.0",
    "r1041_e82_260bps_sup_variant_v4.1.0",
    "r1041_e82_400bps_hac_variant_v4.1.0",
    "r1041_e82_400bps_sup_variant_v4.1.0",
    "r1041_e82_400bps_hac_variant_v4.2.0",
    "r1041_e82_400bps_sup_variant_v4.2.0",
    "r1041_e82_400bps_hac_variant_v4.3.0",
    "r1041_e82_400bps_sup_variant_v4.3.0",
    "r941_sup_plant_variant_g610",
    "r941_min_fast_snp_g507", "r941_min_fast_variant_g507",
    "r941_min_hac_snp_g507",
    "r941_min_sup_snp_g507", "r941_min_sup_variant_g507",
    "r941_prom_fast_snp_g507", "r941_prom_fast_variant_g507",
    "r941_prom_hac_snp_g507",
    "r941_prom_sup_snp_g507", "r941_prom_sup_variant_g507",
    "r103_fast_snp_g507", "r103_fast_variant_g507",
    "r103_hac_snp_g507", "r103_hac_variant_g507",
    "r103_sup_snp_g507", "r103_sup_variant_g507",
    "r941_min_hac_g507", "r941_min_sup_g507",
    "r941_prom_hac_g507", "r941_prom_sup_g507",
    "r941_min_hac_variant_g507",
    "r941_prom_hac_variant_g507",
    "r941_e81_fast_g514", "r941_e81_hac_g514", "r941_e81_sup_g514",
    "r941_e81_fast_variant_g514", "r941_e81_hac_variant_g514",
    "r941_e81_sup_variant_g514",
    "r1041_e82_260bps_joint_apk_ulk_v5.0.0",
    "r1041_e82_400bps_bacterial_methylation",
    "r1041_e82_400bps_hac_v5.0.0_rl_lstm384_dwells",
    "r1041_e82_400bps_hac_v5.0.0_rl_lstm384_no_dwells",
    "r1041_e82_400bps_sup_v5.0.0_rl_lstm384_dwells",
    "r1041_e82_400bps_sup_v5.0.0_rl_lstm384_no_dwells",
    "r1041_e82_400bps_hac_v5.2.0_rl_lstm384_dwells",
    "r1041_e82_400bps_hac_v5.2.0_rl_lstm384_no_dwells",
    "r1041_e82_400bps_sup_v5.2.0_rl_lstm384_dwells",
    "r1041_e82_400bps_sup_v5.2.0_rl_lstm384_no_dwells",
]


deprecated_models = [
    "r941_min_fast_g303", "r941_min_high_g303", "r941_min_high_g330",
    "r941_prom_fast_g303", "r941_prom_high_g303", "r941_prom_high_g330",
    "r941_min_high_g344", "r941_min_high_g351", "r941_min_high_g360",
    "r941_prom_high_g344", "r941_prom_high_g360", "r941_prom_high_g4011",
    "r10_min_high_g303", "r10_min_high_g340",
    "r103_min_high_g345", "r103_min_high_g360", "r103_prom_high_g360",
    "r941_prom_snp_g303", "r941_prom_variant_g303",
    "r941_prom_snp_g322", "r941_prom_variant_g322",
    "r941_prom_snp_g360", "r941_prom_variant_g360",
    "r103_prom_snp_g3210", "r103_prom_variant_g3210",
    "r941_min_high_g340_rle",
]

for _models in basecaller_models.values():
    archived_models.extend(m for m in _models if m is not None)
known_models = sorted(set(current_models + archived_models))


class DeprecationError(ValueError):
    """Raised when trying to resolve a deprecated model."""

    def __init__(self, model):
        """Name the deprecated model."""
        super().__init__(
            "Model '{}' is deprecated; use original medaka v1.x to run "
            "it.".format(model))
