"""The port's static checks (counterpart of ``repro.tools``): stdlib
``ast`` only, importing neither ``torch`` nor ``jax`` nor the JAX package.

* :mod:`repro_torch.tools.import_integrity`: every ``repro_torch.*`` import
  resolves, and the port's side imports nothing of JAX.
* :mod:`repro_torch.tools.torchlint`: the port's contracts as lint rules,
  and the dead-exports report over ``src/repro_torch``.
"""
