"""Model catalogue and related options.

Counterpart of ``medaka_tpu/options.py``: the basecaller -> model
mappings and model lists (``known_models``, ``allowed_models``,
``deprecated_models``, the bacterial methylation model), the model
stores (``model_stores[0]`` the bundles that ship with ``medaka_tpu``,
read by path; ``model_stores[1]`` the user store ``~/.medaka_tpu/data``,
shared with ``medaka_tpu`` so either package finds a model the other
cached), the download URL template and the mapper settings per model
kind. ``models.download_model`` fetches a known model that is not on
disk from :data:`model_url_template` (or a template the caller gives,
``file://`` URLs included) into the user store.
"""
from __future__ import annotations

import os
import pathlib

default_models = {
    "consensus": "r1041_e82_400bps_sup_v5.2.0",
    "variant": "r1041_e82_400bps_sup_variant_v5.0.0",
}

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


bact_methyl_model = "r1041_e82_400bps_bacterial_methylation"
bact_methyl_compatible_models = [
    "r1041_e82_400bps_hac_v4.2.0", "r1041_e82_400bps_sup_v4.2.0",
    "r1041_e82_400bps_hac_v4.3.0", "r1041_e82_400bps_sup_v4.3.0",
    "r1041_e82_400bps_hac_v5.0.0", "r1041_e82_400bps_sup_v5.0.0",
    "r1041_e82_400bps_hac_v5.2.0", "r1041_e82_400bps_sup_v5.2.0",
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
allowed_models = sorted(set(known_models) - set(deprecated_models))

model_subdir = "data"
model_stores = (
    os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "medaka_tpu",
        model_subdir)),
    os.path.join(str(pathlib.Path.home()), ".medaka_tpu", model_subdir),
)
#: where the reference's model tarballs are published; ``{fname}`` is
#: ``<model>_model_pt.tar.gz``
model_url_template = (
    "https://github.com/nanoporetech/medaka/raw/master/medaka/data/{fname}")

alignment_params = {
    "rle": "-M 5 -S 4 -O 2 -E 3",
    "non-rle": "-M 2 -S 4 -O 4,24 -E 2,1"}


class DeprecationError(ValueError):
    """Raised when trying to resolve a deprecated model."""

    def __init__(self, model):
        """Name the deprecated model."""
        super().__init__(
            "Model '{}' is deprecated; use original medaka v1.x to run "
            "it.".format(model))
