"""Generation metrics: CD, EMD, JSD, MMD and FRID (RangeNet features), on the
host and their device-side sufficient statistics."""
