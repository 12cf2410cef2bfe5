"""Launchers: the serve and train CLIs, input specs, the mesh, cost models.

Counterpart of ``repro.launch`` on one device: ``serve``, ``train``,
``specs``, ``mesh.make_mesh`` and ``hlo_analysis``'s serving cost models.
The production mesh and the multi-pod dry-run wait for the sharded step
(ROADMAP A8).
"""
