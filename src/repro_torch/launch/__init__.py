"""Entry points of the port's LM substrate: serving and training, on one
device or a device mesh (``mesh.make_mesh_for``), and the multi-pod
dry-run (``dryrun``, on ``mesh.make_production_mesh``'s fake 256- and
512-rank groups)."""
from .mesh import init_process_group, make_mesh_for, make_production_mesh, spawn
