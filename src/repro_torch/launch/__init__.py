"""Launchers: the serve and train CLIs, input specs, the meshes, cost models.

Counterpart of ``repro.launch``: ``serve``, ``train`` (on a ``(world, 1)``
mesh, ZeRO-3 over a world larger than one), ``specs``, ``mesh.make_mesh``
and ``mesh.make_production_mesh`` (the 16 x 16 and 2 x 16 x 16 meshes on
torch's fake process group), ``hlo_analysis`` (the serving cost models,
``CollectiveStats`` and ``parse_collectives``), ``hlo_counter`` (per-device
FLOPs, bytes and collectives of a step, counted from the ATen ops it
dispatches) and ``dryrun`` (every arch x shape x production mesh, counted on
``meta`` tensors, priced on ``H100_SXM``).
"""
