"""Synchronizing CUDA calls in one fit (torch.cuda.set_sync_debug_mode)."""

def read(rec):
    return rec["syncs"] if rec["kind"] == "fit" else None
