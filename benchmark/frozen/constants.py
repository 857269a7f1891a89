"""Physical and system constants shared across the framework.

Values mirror the reference's use sites (e.g. GPS/GPS_L1CA/include/satpos.m:31-38,
Common/leastSquarePos.m, GLO/GLO_GL1/include/satpos.m) but live in one place here.
"""

# Speed of light [m/s] (GPS/GPS_L1CA/initSettings.m:129)
SPEED_OF_LIGHT = 299_792_458.0

# Pi as defined for the GPS coordinate system (IS-GPS-200; satpos.m:31)
GPS_PI = 3.1415926535898

# WGS-84 / GPS constants (satpos.m:35-38)
OMEGA_E_DOT = 7.2921151467e-5      # Earth rotation rate [rad/s]
GM_EARTH = 3.986005e14             # WGS-84 gravitational constant [m^3/s^2]
REL_F = -4.442807633e-10           # Relativistic correction constant [s/m^0.5]

# WGS-84 ellipsoid
WGS84_A = 6378137.0                # semi-major axis [m]
WGS84_FINV = 298.257223563        # inverse flattening
