from coarse3d_tpu_torch.postproc.border import border_mask
from coarse3d_tpu_torch.postproc.crf import crf_refine

# KNN lives in ops.knn (it is part of the hot inference path); re-exported
# here to mirror the reference's postproc package surface.
from coarse3d_tpu_torch.ops.knn import knn_postprocess

__all__ = ["border_mask", "crf_refine", "knn_postprocess"]
