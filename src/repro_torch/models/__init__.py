"""The LM stack of the port: ``common`` (config and primitive layers),
``rope``, ``attention`` (prefill attention, and decode attention on the
``kernels.swa`` kernel), ``mlp`` (the SwiGLU MLP and the MoE layer) and
``transformer``, for the dense and MoE families. The SSM, hybrid, audio
and VLM families are not ported yet."""
