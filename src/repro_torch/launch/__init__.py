"""Launchers: the serve and train CLIs, input specs, the meshes, cost models.

Counterpart of ``repro.launch``: ``serve``, ``train`` (on a ``(world, 1)``
mesh, ZeRO-3 over a world larger than one), ``specs``, ``mesh.make_mesh``
and ``mesh.make_production_mesh`` (the 16 x 16 and 2 x 16 x 16 meshes on
torch's fake process group), and ``hlo_analysis``'s serving cost models.
The multi-pod dry-run (``dryrun``, ``hlo_counter``) is not ported yet.
"""
