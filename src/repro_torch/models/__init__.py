"""The LM stack of the port: ``common`` (config and primitive layers),
``rope``, ``attention`` (prefill attention, and decode attention on the
``kernels.swa`` kernel), ``mlp`` (the SwiGLU MLP and the MoE layer),
``ssm`` (the Mamba2 / SSD layer), ``rglru`` (the RG-LRU block) and
``transformer``, for the dense, MoE, SSM, hybrid, audio and VLM
families."""
