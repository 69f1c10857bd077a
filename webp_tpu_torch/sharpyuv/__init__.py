"""SharpYUV: the host converter (numpy), the port's own copy."""
