"""Models of the PyTorch port.

Counterpart of ``dmlc_core_tpu/models``, with the same exports: the linear
learners (:mod:`.linear`) and hist-GBDT (:mod:`.gbdt`); the MLP is
:mod:`.mlp` and the scikit-learn estimators :mod:`.sklearn`.
"""

from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam  # noqa: F401
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble  # noqa: F401
