from rts_tpu_torch.geometry.mesh import Mesh
from rts_tpu_torch.geometry.rect import rect_mesh
from rts_tpu_torch.geometry.sphere import sphere_mesh
from rts_tpu_torch.geometry.filemesh import file_mesh, write_mesh_files
from rts_tpu_torch.geometry.terrain import fractal_heights, terrain_mesh

__all__ = [
    "Mesh",
    "fractal_heights",
    "file_mesh",
    "rect_mesh",
    "sphere_mesh",
    "terrain_mesh",
    "write_mesh_files",
]
