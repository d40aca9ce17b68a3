from cgcnet_tpu_torch.preprocess.features import (
    extract_patch_features,
    glcm_stats,
    local_entropy,
    nucleus_intensity_stats,
)

__all__ = [
    "extract_patch_features",
    "glcm_stats",
    "local_entropy",
    "nucleus_intensity_stats",
]
