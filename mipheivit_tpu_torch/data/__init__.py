"""Host-side data helpers of the port (channel statistics, normalization codecs)."""
