"""Error contract, dtype policy and small dense linear algebra."""
