"""The dense LM stack of the port: ``common`` (config and primitive
layers), ``rope``, ``attention`` (prefill attention, and decode attention
on the ``kernels.swa`` kernel), ``mlp`` and ``transformer``. The MoE, SSM,
hybrid, audio and VLM families are not ported yet."""
