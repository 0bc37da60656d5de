"""Physical and GNSS constants.

Capability parity with the reference SyDR constants module
(``sydr/utils/constants.py``), re-derived from the public
IS-GPS-200 interface specification and standard geodesy references.
"""

# --- Generic -----------------------------------------------------------------
GPS_PI = 3.1415926535898            # pi as defined by IS-GPS-200
SPEED_OF_LIGHT = 299792458.0        # [m/s]

# --- Time --------------------------------------------------------------------
SECONDS_PER_DAY = 86400.0
SECONDS_PER_WEEK = 604800.0
HALF_WEEK_SECONDS = 302400.0
GPS_WEEK_ROLLOVER = 2               # current 1024-week rollover count

# Average signal travel time used to bootstrap the receiver clock (ms).
AVG_TRAVEL_TIME_MS = 76.0

# --- Earth -------------------------------------------------------------------
EARTH_RADIUS = 6378137.0            # [m] WGS-84 semi-major axis
EARTH_ROTATION_RATE = 7.2921151467e-5   # [rad/s] omega_e_dot
EARTH_GM = 3.986005e14              # [m^3/s^2] WGS-84 value of IS-GPS-200
WGS84_F = 1.0 / 298.257223563       # WGS-84 flattening

# Relativistic clock correction constant F [s/sqrt(m)] (IS-GPS-200 20.3.3.3.3.1)
RELATIVISTIC_CLOCK_F = -4.442807633e-10

# --- GPS L1 C/A signal -------------------------------------------------------
GPS_L1CA_CARRIER_FREQ = 1575.42e6   # [Hz]
GPS_L1CA_CODE_LENGTH = 1023         # chips per code period
GPS_L1CA_CODE_FREQ = 1.023e6        # [Hz] chipping rate
GPS_L1CA_CODE_PERIOD_MS = 1         # code periods per millisecond

# --- LNAV navigation message -------------------------------------------------
LNAV_PREAMBLE = (1, 0, 0, 0, 1, 0, 1, 1)
LNAV_PREAMBLE_SIZE = 8
LNAV_MS_PER_BIT = 20                # 50 bps data rate
LNAV_WORD_SIZE = 30                 # bits per word
LNAV_SUBFRAME_SIZE = 300            # bits per subframe (10 words)
LNAV_SUBFRAME_SECONDS = 6

# --- Kaplan digital loop filter constants (Kaplan 2006, table 5.6) -----------
DLF_W0_SCALE_1ST = 0.25             # Bn = 0.25 * w0 for 1st order loop
DLF_W0_SCALE_2ND = 0.53             # Bn = 0.53 * w0 for 2nd order loop
DLF_W0_SCALE_3RD = 0.7845           # Bn = 0.7845 * w0 for 3rd order loop
DLF_A2 = 1.414                      # 2nd order loop coefficient
DLF_A3 = 1.1                        # 3rd order loop coefficient
DLF_B3 = 2.4                        # 3rd order loop coefficient

# --- Tropospheric model tables (Collins/ESA standard atmosphere) -------------
TROPO_K1 = 77.604                   # [K/mbar]
TROPO_K2 = 382000.0                 # [K^2/mbar]
TROPO_RD = 287.054                  # [J/(kg K)]
TROPO_GM = 9.784                    # [m/s^2]
TROPO_G = 9.80665                   # [m/s^2]

# Latitude-interpolated meteorological parameter tables: latitude [deg],
# average and seasonal-variation values of P0 [mbar], T0 [K], e0 [mbar],
# beta [K/m], lambda [-].
TROPO_LAT_GRID = (15.0, 30.0, 45.0, 60.0, 75.0)
TROPO_AVG_P0 = (1013.25, 1017.25, 1015.75, 1011.75, 1013.00)
TROPO_AVG_T0 = (299.65, 294.15, 283.15, 272.15, 263.65)
TROPO_AVG_E0 = (26.31, 21.79, 11.66, 6.78, 4.11)
TROPO_AVG_BETA = (6.30e-3, 6.05e-3, 5.58e-3, 5.39e-3, 4.53e-3)
TROPO_AVG_LAMBDA = (2.77, 3.15, 2.57, 1.81, 1.55)
TROPO_VAR_P0 = (0.0, -3.75, -2.25, -1.75, -0.50)
TROPO_VAR_T0 = (0.0, 7.00, 11.00, 15.00, 14.50)
TROPO_VAR_E0 = (0.0, 8.85, 7.24, 5.36, 3.39)
TROPO_VAR_BETA = (0.0, 0.25e-3, 0.32e-3, 0.81e-3, 0.62e-3)
TROPO_VAR_LAMBDA = (0.0, 0.33, 0.46, 0.74, 0.30)

# --- Ionospheric (geomagnetic pole, Klobuchar) -------------------------------
IONO_MAG_POLE_LAT = 78.3            # [deg]
IONO_MAG_POLE_LON = 291.0           # [deg]
