"""Plain torch layer of the port: combiners, scans, sorters, engine, SWAG."""
