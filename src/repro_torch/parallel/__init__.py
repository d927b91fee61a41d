"""Explicit-collective parallelism of the port on ``torch.distributed``:
the mesh collectives (:mod:`.collectives`) and the GPipe pipeline
(:mod:`.pipeline`)."""
from repro_torch.launch.mesh import (ProcessMesh, get_mesh, make_mesh,
                                     set_mesh)
from repro_torch.parallel.collectives import (USED, all_gather, all_to_all,
                                              axis_index, axis_size,
                                              backend_for, gather_stream,
                                              init_process_group, pmean,
                                              ppermute, psum, replicated,
                                              split_stream)
from repro_torch.parallel.pipeline import (bubble_fraction, pipeline_apply,
                                           stack_layer_groups)

__all__ = ["ProcessMesh", "USED", "all_gather", "all_to_all", "axis_index",
           "axis_size", "backend_for", "bubble_fraction", "gather_stream",
           "get_mesh", "init_process_group", "make_mesh", "pipeline_apply",
           "pmean", "ppermute", "psum", "replicated", "set_mesh",
           "split_stream", "stack_layer_groups"]
