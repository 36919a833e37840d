"""kernel.textcnn_fwd.wgmma_share.<entry>: the share of the row-gathered
TextCNN forward's launches that took its warpgroup (`wgmma`) body, in
percent: 100 x the counter "textcnn_pool_fwd_rows.wgmma" over
"textcnn_pool_fwd_rows" (`train.profiler.counters`, every launch of the
process, CUDA-graph replays included). Nothing where no rows forward
ran, or where the program has no such body (no
`ops.textcnn.FWD_ROWS_WGMMA`)."""

from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.train import profiler


def read(record):
    name = getattr(textcnn, "FWD_ROWS_WGMMA", None)
    counters = getattr(profiler, "counters", {})
    launches = counters.get("textcnn_pool_fwd_rows", 0)
    if name is None or not launches:
        return None
    return 100.0 * counters.get(name, 0) / launches
