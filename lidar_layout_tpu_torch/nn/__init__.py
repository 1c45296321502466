"""Neural building blocks: circular convs, norms, resampling, attention, VQ."""
