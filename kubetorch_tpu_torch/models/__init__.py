"""Models of the port: plain functions over params dicts keyed like the JAX
package's trees (``kubetorch_tpu_torch.models.convert.params_from_numpy``
carries one over)."""

from kubetorch_tpu_torch.models.configs import LlamaConfig, MoEConfig
from kubetorch_tpu_torch.models import llama
from kubetorch_tpu_torch.models import quant
from kubetorch_tpu_torch.models.quant import quantize_params
from kubetorch_tpu_torch.models.generate import Generator
from kubetorch_tpu_torch.models.embed import Embedder
from kubetorch_tpu_torch.models.rolling import RollingGenerator
from kubetorch_tpu_torch.models.convert import params_from_numpy

__all__ = ["LlamaConfig", "MoEConfig", "llama", "quant", "quantize_params",
           "Generator", "Embedder", "RollingGenerator",
           "params_from_numpy"]
