"""Generation metrics: CD, EMD, JSD, MMD, FRID (RangeNet features), FSVD and
FPVD (MinkowskiNet and SPVCNN features), on the host and their device-side
sufficient statistics."""
