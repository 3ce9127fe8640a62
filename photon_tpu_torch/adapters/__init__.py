"""Per-cohort LoRA adapters over a frozen federated base: the payload
algebra (``lora.py``), the round checkpoint layout (``checkpoint.py``)
and the train side's plane (``federated.py``). Serving reads the bank
through ``serve/adapter_pool.py``."""

from photon_tpu_torch.adapters.checkpoint import (  # noqa: F401
    adapter_key,
    adapter_state_key,
    adapter_state_keys,
    load_adapter_bank,
)
from photon_tpu_torch.adapters.federated import (  # noqa: F401
    AdapterTrainPlane,
    configure_adapter_training,
)
from photon_tpu_torch.adapters.lora import (  # noqa: F401
    BASE_FREEZE_PATTERN,
    AdapterSpec,
    adapter_metadata,
    adapter_tree,
    cohort_seed,
    init_adapter_arrays,
    is_adapter_name,
    merge_adapter_into_base,
    merge_payload,
    spec_from_base,
    spec_from_params,
    split_adapter,
    stack_adapter_trees,
)
