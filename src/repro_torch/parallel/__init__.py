from repro_torch.parallel.sharding import (  # noqa: F401
    make_param_shardings, activation_resolver, install_activation_rules,
    batch_sharding, input_shardings,
)
