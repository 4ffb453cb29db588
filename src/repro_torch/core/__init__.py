"""ROO core: masks, the HSTU layer, the ROO batch, sequence packing and
the request-level joiner (torch port of ``repro/core``)."""
from repro_torch.core.roo_batch import ROOBatch, segment_ids_from_counts
from repro_torch.core.fanout import fanout, fanin_sum, fanin_mean, fanout_local
