"""Multi-device parallelism on ``torch.distributed``, the counterpart of
``molly_tpu/parallel``: the mesh and its sharding rules (``sharding``, with
the collectives in ``comm``), ring attention over a ``seq`` axis
(``ring_attention``) and the GPipe pipeline over a ``pipe`` axis
(``pipeline``)."""

from .comm import Mesh, current_mesh, use_mesh
from .pipeline import (
    decoder_forward_pp,
    make_pp_mesh,
    pp_loss_fn,
    pp_param_specs,
)
from .ring_attention import (
    ring_attention,
    ring_attention_sharded,
)
from .sharding import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    batch_specs,
    host_shard_range,
    initialize_distributed,
    make_global_batch,
    make_mesh,
    param_specs,
    shard_batch,
    shard_params,
    spec_for_path,
)
