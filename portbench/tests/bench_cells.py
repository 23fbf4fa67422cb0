"""What the benchmark's tests share: the cells at a size the CPU holds."""

from portbench.harness import load_cell, load_manifest

# each mix cut to a few stamps or a small field: the same code paths,
# the CPU's size
TINY = {
    "stamps": {"batch": 4, "pool_batches": 2, "warmup_steps": 1, "trace_steps": 2},
    "field": {"field_size": 512, "galaxies": 150, "pool_fields": 2, "tile_size": 256, "tile_overlap": 32,
              "warmup_steps": 0, "trace_steps": 1},
}
SEED = 2**31 + 977


def cells():
    manifest = load_manifest()
    return [w["name"] for w in manifest["workloads"]]


def tiny(workload):
    """(manifest, cell, mix overrides) of ``workload`` at the CPU's size."""
    manifest = load_manifest()
    cell = load_cell(manifest, workload)
    return manifest, cell, TINY[cell["mix_data"]["driver"]]
