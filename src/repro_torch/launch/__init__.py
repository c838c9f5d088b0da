"""Entry points of the port's LM substrate: serving and training, on one
device or a device mesh (``mesh.make_mesh_for``).

The reference's ``make_production_mesh`` comes with its multi-pod dry-run
(ROADMAP Queue 1 item 6b, slice 10)."""
from .mesh import init_process_group, make_mesh_for, spawn
