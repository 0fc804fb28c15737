"""Scale-out: template batches sharded over a device mesh
(:mod:`.mesh`) and many queries over many hosts (:mod:`.multihost`)."""
